"""AsyncProcess: asyncio-friendly subprocess management (reference process.py).

Wraps ``multiprocessing`` (spawn context — fork is unsafe with asyncio and
JAX runtimes) so a Server can start/kill/await child processes without
blocking its event loop.  A daemon watcher thread joins the child and
posts the exit code back onto the loop, firing registered exit callbacks
(the Nanny's auto-restart hook, reference nanny.py:546).
"""

from __future__ import annotations

import asyncio
import logging
import multiprocessing
import threading
from typing import Any, Callable

logger = logging.getLogger("distributed_tpu_torch.process")

_ctx = multiprocessing.get_context("spawn")


class AsyncProcess:
    """A spawned child process with async start/join/kill (reference
    process.py:43)."""

    def __init__(self, target: Callable, args: tuple = (), kwargs: dict | None = None,
                 name: str | None = None):
        self._process = _ctx.Process(
            target=target, args=args, kwargs=kwargs or {}, name=name
        )
        self._process.daemon = True
        self._watch_thread: threading.Thread | None = None
        self._exit_future: asyncio.Future | None = None
        self._exit_callback: Callable[[int | None], None] | None = None
        self._loop: asyncio.AbstractEventLoop | None = None

    @property
    def pid(self) -> int | None:
        return self._process.pid

    @property
    def exitcode(self) -> int | None:
        return self._process.exitcode

    def is_alive(self) -> bool:
        return self._process.is_alive()

    def set_exit_callback(self, callback: Callable[[int | None], None]) -> None:
        self._exit_callback = callback

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._exit_future = self._loop.create_future()
        await self._loop.run_in_executor(None, self._process.start)
        self._watch_thread = threading.Thread(
            target=self._watch, name=f"AsyncProcess-watch-{self._process.name}",
            daemon=True,
        )
        self._watch_thread.start()

    def _watch(self) -> None:
        self._process.join()
        code = self._process.exitcode
        loop = self._loop
        if loop is None or loop.is_closed():
            return
        def _fire() -> None:
            if self._exit_future is not None and not self._exit_future.done():
                self._exit_future.set_result(code)
            if self._exit_callback is not None:
                try:
                    self._exit_callback(code)
                except Exception:
                    logger.exception("process exit callback failed")
        try:
            loop.call_soon_threadsafe(_fire)
        except RuntimeError:
            pass  # loop shut down meanwhile

    async def join(self, timeout: float | None = None) -> int | None:
        assert self._exit_future is not None, "not started"
        return await asyncio.wait_for(asyncio.shield(self._exit_future), timeout)

    async def terminate(self) -> None:
        """SIGTERM (graceful-ish)."""
        if self._process.is_alive():
            await asyncio.get_running_loop().run_in_executor(
                None, self._process.terminate
            )

    async def kill(self) -> None:
        """SIGKILL."""
        if self._process.is_alive():
            await asyncio.get_running_loop().run_in_executor(
                None, self._process.kill
            )

    def __repr__(self) -> str:
        return (
            f"<AsyncProcess {self._process.name} pid={self.pid} "
            f"exitcode={self.exitcode}>"
        )
