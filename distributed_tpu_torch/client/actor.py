"""Actors: stateful tasks pinned to one worker (reference actor.py).

``client.submit(MyClass, actor=True)`` runs the constructor once on a
worker; the instance stays in ``worker.state.actors`` and the task's
"value" is an ``ActorPlaceholder``.  Resolving the future yields an
``Actor`` proxy whose method calls are direct client->worker RPCs
(``actor_execute``, reference worker.py:2159) bypassing the scheduler,
and whose plain attributes are fetched via ``actor_attribute``.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
from typing import Any, Callable

from distributed_tpu_torch.protocol.serialize import Serialize, unwrap
from distributed_tpu_torch.rpc.core import rpc as _rpc


class ActorFuture:
    """Result handle for one actor method call (reference actor.py:22
    BaseActorFuture / EagerActorFuture).

    Usable from BOTH worlds: ``await fut`` on the event loop, or the
    concurrent.futures-style sync surface — ``result(timeout)``,
    ``done()``, ``add_done_callback(fn)`` — from ordinary threads (the
    blocking client facade).  Also accepted by ``as_completed`` next to
    task futures."""

    def __init__(self, coro, loop: asyncio.AbstractEventLoop | None = None):
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        self._loop = loop or running
        if running is not None and self._loop is running:
            self._task: Any = asyncio.ensure_future(coro)
        elif self._loop is not None:
            # called from a foreign thread (sync facade): schedule on
            # the client's loop, expose a thread-safe handle
            self._task = asyncio.run_coroutine_threadsafe(coro, self._loop)
        else:
            raise RuntimeError(
                "ActorFuture needs a running event loop (or pass loop=)"
            )

    def __await__(self):
        task = self._task
        if isinstance(task, concurrent.futures.Future):
            return asyncio.wrap_future(task).__await__()
        return task.__await__()

    def done(self) -> bool:
        return self._task.done()

    def result(self, timeout: float | None = None) -> Any:
        """Block for the result.  From a foreign thread this waits on
        the concurrent future; ON the event loop thread it must not
        block — use ``await`` there."""
        task = self._task
        if isinstance(task, concurrent.futures.Future):
            return task.result(timeout)
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            pass
        else:
            raise RuntimeError(
                "ActorFuture.result() would block the event loop; "
                "use `await fut` here"
            )
        # asyncio.Task owned by a loop running in another thread
        done = concurrent.futures.Future()

        def _transfer(t):
            if t.cancelled():
                done.cancel()
            elif t.exception() is not None:
                done.set_exception(t.exception())
            else:
                done.set_result(t.result())

        task.get_loop().call_soon_threadsafe(
            lambda: task.add_done_callback(_transfer)
        )
        return done.result(timeout)

    def add_done_callback(self, fn: Callable) -> None:
        task = self._task
        if isinstance(task, concurrent.futures.Future):
            task.add_done_callback(fn)
            return
        try:
            on_loop = asyncio.get_running_loop() is task.get_loop()
        except RuntimeError:
            on_loop = False
        if on_loop:
            task.add_done_callback(fn)
        else:
            # asyncio.Task callbacks are NOT thread-safe: mutate the
            # callback list only on the owning loop
            task.get_loop().call_soon_threadsafe(task.add_done_callback, fn)

    def cancel(self) -> bool:
        task = self._task
        if isinstance(task, concurrent.futures.Future):
            return task.cancel()
        try:
            on_loop = asyncio.get_running_loop() is task.get_loop()
        except RuntimeError:
            on_loop = False
        if on_loop:
            return task.cancel()
        task.get_loop().call_soon_threadsafe(task.cancel)
        return True  # best effort from a foreign thread

    def __repr__(self) -> str:
        state = "done" if self.done() else "pending"
        return f"<ActorFuture {state}>"


class ActorPlaceholder:
    """The stored 'value' of an actor task: (class, key, worker address)."""

    __slots__ = ("cls", "key", "worker")

    def __init__(self, cls: type, key: str, worker: str):
        self.cls = cls
        self.key = key
        self.worker = worker

    def __reduce__(self):
        return (ActorPlaceholder, (self.cls, self.key, self.worker))

    def __repr__(self) -> str:
        return f"<ActorPlaceholder {self.cls.__name__} {self.key} on {self.worker}>"


class Actor:
    """Client-side proxy to a remote actor instance (reference actor.py:22)."""

    def __init__(self, cls: type, worker: str, key: str, io: Any = None,
                 loop: asyncio.AbstractEventLoop | None = None):
        self._cls = cls
        self._worker = worker
        self._key = key
        self._io = io if io is not None else _rpc(worker)
        try:
            self._loop = loop or asyncio.get_running_loop()
        except RuntimeError:
            self._loop = loop

    @classmethod
    def from_placeholder(cls, ph: ActorPlaceholder, io: Any = None,
                         loop: asyncio.AbstractEventLoop | None = None) -> "Actor":
        return cls(ph.cls, ph.worker, ph.key, io=io, loop=loop)

    def __repr__(self) -> str:
        return f"<Actor: {self._cls.__name__}, key={self._key}>"

    def __dir__(self):
        return sorted(set(dir(type(self))) | {
            a for a in dir(self._cls) if not a.startswith("_")
        })

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        attr = getattr(self._cls, name, None)
        if callable(attr):
            def call(*args: Any, **kwargs: Any) -> "ActorFuture":
                # validate loop availability BEFORE building the
                # coroutine: raising after _run() exists leaks a
                # never-awaited coroutine and buries the real error
                # under a RuntimeWarning
                loop = self._loop
                if loop is None:
                    try:
                        loop = asyncio.get_running_loop()
                    except RuntimeError:
                        raise RuntimeError(
                            f"actor call {name}() needs a running event "
                            "loop (construct the Actor with loop=, or "
                            "call from async code)"
                        ) from None

                async def _run():
                    resp = await self._io.actor_execute(
                        actor=self._key,
                        function=name,
                        args=Serialize(args),
                        kwargs=Serialize(kwargs),
                    )
                    if resp.get("status") == "error":
                        from distributed_tpu_torch.rpc.core import (
                            raise_remote_error,
                        )

                        raise_remote_error(resp)
                    return unwrap(resp["result"])

                return ActorFuture(_run(), loop=loop)

            return call

        async def get_attribute():
            resp = await self._io.actor_attribute(
                actor=self._key, attribute=name
            )
            if resp.get("status") == "error":
                from distributed_tpu_torch.rpc.core import raise_remote_error

                raise_remote_error(resp)
            return unwrap(resp["result"])

        return get_attribute()
