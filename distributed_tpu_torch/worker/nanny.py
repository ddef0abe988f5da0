"""Nanny: supervises a Worker subprocess (reference nanny.py).

The Nanny is a small Server that spawns the real Worker in a child
process (spawn context), reports its address back, restarts it when it
dies unexpectedly (reference ``_on_worker_exit`` nanny.py:546), and kills
it with escalation (graceful close -> SIGTERM -> SIGKILL, nanny.py:393).
Scheduler-initiated restarts go through the ``restart``/``kill`` RPCs.
"""

from __future__ import annotations

import asyncio
import logging
import multiprocessing
import os
from typing import Any

from distributed_tpu_torch import config
from distributed_tpu_torch.rpc.core import Server, Status
from distributed_tpu_torch.worker.process import AsyncProcess

logger = logging.getLogger("distributed_tpu_torch.nanny")


def _run_worker_process(scheduler_addr: str, worker_kwargs: dict,
                        env: dict, q: multiprocessing.Queue) -> None:
    """Child-process entry: run a Worker until it closes."""
    for k, v in env.items():
        os.environ[k] = str(v)

    import asyncio as _asyncio

    async def main() -> None:
        from distributed_tpu_torch.worker.server import Worker

        worker = Worker(scheduler_addr, **worker_kwargs)
        try:
            await worker.start()
        except Exception as e:  # startup failure: tell the parent
            q.put({"op": "start-failed", "error": repr(e)})
            raise
        q.put({"op": "started", "address": worker.address})
        await worker.finished()

    try:
        _asyncio.run(main())
    except KeyboardInterrupt:
        pass


class Nanny(Server):
    """Worker supervisor process (reference nanny.py:69)."""

    blocked_handlers_config_key = "nanny.blocked-handlers"
    preload_config_prefix = "nanny"

    def __init__(
        self,
        scheduler_addr: str,
        *,
        nthreads: int = 1,
        name: object = None,
        memory_limit: int = 0,
        auto_restart: bool = True,
        worker_kwargs: dict | None = None,
        env: dict | None = None,
        listen_addr: str | None = None,
        lifetime: float | None = None,
        lifetime_stagger: float | None = None,
        lifetime_restart: bool | None = None,
        security: Any | None = None,
        **server_kwargs: Any,
    ):
        self.security = security
        if security is not None:
            # the nanny's own control channel (kill/restart/terminate)
            # and its scheduler rpc must ride TLS like everything else
            server_kwargs.setdefault(
                "connection_args", security.get_connection_args("worker")
            )
        self.scheduler_addr = scheduler_addr
        self.nthreads = nthreads
        self.worker_name = name
        self.memory_limit = memory_limit
        self.auto_restart = auto_restart
        from distributed_tpu_torch.worker import resolve_lifetime

        self.lifetime, self.lifetime_stagger, self.lifetime_restart = (
            resolve_lifetime(lifetime, lifetime_stagger, lifetime_restart)
        )
        self._lifetime_task: Any | None = None
        self.env = dict(config.get("nanny.environ") or {})
        self.env.update(env or {})
        self.worker_kwargs = dict(worker_kwargs or {})
        self._listen_addr = listen_addr
        self.process: AsyncProcess | None = None
        self.worker_address: str | None = None
        self._start_queue: multiprocessing.Queue | None = None
        self._restart_attempts = 0
        self.MAX_RESTART_ATTEMPTS = 3

        handlers = {
            "instantiate": self.instantiate_rpc,
            "kill": self.kill_rpc,
            "restart": self.restart_rpc,
            "terminate": self.close_rpc,
            "worker_address": self.get_worker_address,
            "run": self.run_function,
            "plugin_add": self.plugin_add,
            "plugin_remove": self.plugin_remove,
        }
        self.plugins: dict[str, Any] = {}
        self._local_directory: Any | None = None
        super().__init__(handlers=handlers, name=name, **server_kwargs)

    @property
    def local_directory(self) -> str:
        """Per-nanny scratch directory (lazy WorkSpace claim) — the
        extraction target for NannyPlugins like UploadDirectory, kept
        out of the process CWD and purged when stale."""
        if self._local_directory is None:
            from distributed_tpu_torch.utils.diskutils import WorkSpace

            self._local_directory = WorkSpace().new_work_dir(prefix="nanny")
        return self._local_directory.path

    # ------------------------------------------------------------ lifecycle

    async def start_unsafe(self) -> "Nanny":
        addr = self._listen_addr or (
            "tls://127.0.0.1:0" if self.security is not None
            else "tcp://127.0.0.1:0"
        )
        listen_args = (
            self.security.get_listen_args("worker")
            if self.security is not None else {}
        )
        await self.listen(addr, **listen_args)
        await self.instantiate()
        if self.memory_limit:
            from distributed_tpu_torch.worker.memory import NannyMemoryManager

            self.memory_manager = NannyMemoryManager(self, self.memory_limit)
        if self.lifetime:
            self._lifetime_task = asyncio.create_task(self._lifetime_loop())
        self.start_periodic_callbacks()
        return self

    async def _lifetime_loop(self) -> None:
        """Bounded worker lifetime (reference dask-worker --lifetime):
        after ``lifetime`` (± a uniform stagger so a fleet doesn't cycle
        in lock-step), the worker is retired gracefully; with
        ``lifetime_restart`` a fresh one is spawned, else the nanny shuts
        down.  The tool for bounded-preemption environments."""
        from distributed_tpu_torch.worker import sample_lifetime_delay

        while True:
            delay = sample_lifetime_delay(self.lifetime, self.lifetime_stagger)
            await asyncio.sleep(delay)
            logger.info(
                "worker %s reached its lifetime (%.0fs); %s",
                self.worker_address, delay,
                "restarting" if self.lifetime_restart else "retiring",
            )
            # disarm auto-restart FIRST: retire_workers terminates the
            # worker over RPC, and an armed exit callback would race this
            # loop to spawn a second (or zombie) worker
            if self.process is not None:
                self.process.set_exit_callback(lambda code: None)
            try:
                # retire first: the scheduler replicates unique data away
                # and reschedules queued work before the process dies
                if self.worker_address:
                    await self.rpc(self.scheduler_addr).retire_workers(
                        workers=[self.worker_address]
                    )
            except Exception:
                logger.warning("lifetime retire failed", exc_info=True)
            try:
                await self.kill(graceful=True)
            except Exception:
                logger.exception("lifetime kill failed")
            if not self.lifetime_restart:
                self._ongoing_background_tasks.call_soon(self.close)
                return
            # bounded retry with backoff, like the crash-restart path —
            # a single transient spawn failure must not leave a zombie
            # nanny supervising nothing
            for attempt in range(1, self.MAX_RESTART_ATTEMPTS + 1):
                try:
                    await self.instantiate()
                    break
                except Exception:
                    logger.exception(
                        "lifetime restart failed (attempt %d/%d)",
                        attempt, self.MAX_RESTART_ATTEMPTS,
                    )
                    if attempt < self.MAX_RESTART_ATTEMPTS:
                        await asyncio.sleep(0.5 * attempt)
            else:
                self.status = Status.failed
                self._ongoing_background_tasks.call_soon(self.close)
                return

    async def instantiate(self, timeout: float = 60.0) -> str:
        """Spawn the worker subprocess, wait for its address
        (reference nanny.py:363 / WorkerProcess.start nanny.py:708)."""
        ctx = multiprocessing.get_context("spawn")
        q: multiprocessing.Queue = ctx.Queue()
        self._start_queue = q
        kwargs = dict(self.worker_kwargs)
        kwargs.setdefault("nthreads", self.nthreads)
        kwargs.setdefault("name", self.worker_name)
        kwargs.setdefault("memory_limit", self.memory_limit)
        # the NANNY owns the lifetime (it can restart); zero the child's
        # own config-read timer or both would fire independently
        kwargs.setdefault("lifetime", 0)
        kwargs.setdefault("nanny_addr", self.address)
        if self.security is not None:
            kwargs.setdefault("security", self.security)
        env = dict(config.get("nanny.pre-spawn-environ") or {})
        env.update(self.env)
        self.process = AsyncProcess(
            target=_run_worker_process,
            args=(self.scheduler_addr, kwargs, env, q),
            name=f"dtpu-worker-{self.worker_name or self.id}",
        )
        self.process.set_exit_callback(self._on_worker_exit)
        await self.process.start()
        loop = asyncio.get_running_loop()
        import queue as _queue

        # q.get with its own timeout so the executor thread always exits
        def _get_startup_msg():
            try:
                return q.get(timeout=timeout)
            except _queue.Empty:
                return None

        msg = await loop.run_in_executor(None, _get_startup_msg)
        if msg is None:
            # child hung during startup: reap it, don't leak the process
            self.process.set_exit_callback(lambda code: None)
            await self.process.kill()
            raise TimeoutError(
                f"worker did not start within {timeout}s; killed pid "
                f"{self.process.pid}"
            )
        if msg.get("op") != "started":
            # disarm auto-restart: the caller decides what happens next
            self.process.set_exit_callback(lambda code: None)
            raise RuntimeError(f"worker failed to start: {msg!r}")
        self._restart_attempts = 0
        self.worker_address = msg["address"]
        logger.info(
            "nanny %s started worker %s (pid %s)",
            self.address, self.worker_address, self.process.pid,
        )
        return self.worker_address

    def _on_worker_exit(self, exitcode: int | None) -> None:
        """The worker process died (reference nanny.py:546)."""
        if self.status in (Status.closing, Status.closed, Status.failed):
            return
        logger.warning(
            "worker process %s exited with code %s", self.worker_address, exitcode
        )
        if self.auto_restart:
            logger.info("nanny restarting worker")
            self._ongoing_background_tasks.call_soon(self._restart_on_exit)

    async def _restart_on_exit(self) -> None:
        self._restart_attempts += 1
        if self._restart_attempts > self.MAX_RESTART_ATTEMPTS:
            logger.error(
                "worker failed to start %d times; nanny giving up",
                self._restart_attempts - 1,
            )
            self.status = Status.failed
            return
        await asyncio.sleep(0.5 * self._restart_attempts)  # backoff
        try:
            await self.instantiate()
        except Exception:
            logger.exception("nanny failed to restart worker")
            self._on_worker_exit(None)

    async def kill(self, timeout: float = 5.0, *, graceful: bool = True) -> None:
        """Stop the worker with escalation (reference nanny.py:393)."""
        process = self.process
        if process is None or not process.is_alive():
            return
        process.set_exit_callback(lambda code: None)  # no auto-restart
        if graceful and self.worker_address:
            from distributed_tpu_torch.exceptions import CommClosedError

            try:
                await asyncio.wait_for(
                    self.rpc(self.worker_address).terminate(), timeout / 2
                )
            except (CommClosedError, OSError, asyncio.TimeoutError, RuntimeError):
                pass
        try:
            await asyncio.wait_for(process.join(), timeout / 2)
            return
        except asyncio.TimeoutError:
            pass
        await process.terminate()
        try:
            await asyncio.wait_for(process.join(), timeout / 2)
            return
        except asyncio.TimeoutError:
            pass
        logger.warning("escalating to SIGKILL for pid %s", process.pid)
        await process.kill()
        await process.join()

    async def restart(self, timeout: float = 30.0) -> str:
        await self.kill(timeout=timeout / 2)
        return await self.instantiate(timeout=timeout)

    async def close(self, timeout: float | None = None) -> None:
        if self.status in (Status.closed, Status.closing):
            await self.finished()
            return
        self.status = Status.closing
        await self._teardown_config_preloads()
        logger.info("closing nanny %s", self.address)
        if self._lifetime_task is not None:
            self._lifetime_task.cancel()
            self._lifetime_task = None
        await self.kill()
        await super().close()

    # ------------------------------------------------------------- handlers

    async def instantiate_rpc(self) -> str:
        return await self.instantiate()

    async def kill_rpc(self, timeout: float = 5.0) -> str:
        await self.kill(timeout=timeout)
        return "OK"

    async def restart_rpc(self, timeout: float = 30.0) -> str:
        await self.restart(timeout=timeout)
        return "OK"

    async def close_rpc(self, reason: str = "") -> str:
        self._ongoing_background_tasks.call_soon(self.close)
        return "OK"

    async def run_function(self, function: Any = None, args: Any = None,
                           kwargs: Any = None, wait: bool = True) -> Any:
        """Run an arbitrary function on this nanny (client.run(nanny=True),
        reference nanny run handler)."""
        from distributed_tpu_torch.rpc.core import run_user_function

        return await run_user_function(
            self, "dtpu_nanny", function, args, kwargs, wait
        )

    async def plugin_add(self, plugin: Any = None, name: str = "") -> dict:
        """Install a NannyPlugin (reference nanny.py plugin_add):
        idempotent per name (the scheduler re-pushes its plugin set on
        every worker registration), and honors ``plugin.restart`` by
        cycling the worker process so the change reaches the child."""
        from distributed_tpu_torch.protocol.serialize import unwrap
        from distributed_tpu_torch.rpc.core import error_message

        plugin = unwrap(plugin)
        name = name or getattr(plugin, "name", type(plugin).__name__)
        if name in self.plugins:
            return {"status": "OK"}
        self.plugins[name] = plugin
        try:
            setup = getattr(plugin, "setup", None)
            if setup is not None:
                res = setup(self)
                if asyncio.iscoroutine(res):
                    await res
            if getattr(plugin, "restart", False):
                await self.kill(graceful=True)
                await self.instantiate()
        except Exception as e:
            return error_message(e)
        return {"status": "OK"}

    async def plugin_remove(self, name: str = "") -> dict:
        """Uninstall a NannyPlugin (teardown hook honored)."""
        from distributed_tpu_torch.rpc.core import error_message

        plugin = self.plugins.pop(name, None)
        try:
            teardown = getattr(plugin, "teardown", None)
            if teardown is not None:
                res = teardown(self)
                if asyncio.iscoroutine(res):
                    await res
        except Exception as e:
            return error_message(e)
        return {"status": "OK"}

    async def get_worker_address(self) -> str | None:
        return self.worker_address

    def __repr__(self) -> str:
        return f"<Nanny worker={self.worker_address!r} status={self.status.name}>"
