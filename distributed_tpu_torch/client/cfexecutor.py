"""concurrent.futures.Executor facade over a Client (reference cfexecutor.py:46).

``client.get_executor()`` returns an executor whose futures are standard
``concurrent.futures.Future`` objects, bridged from cluster futures on
the client's event loop — drop-in for code written against the stdlib
executor API.
"""

from __future__ import annotations

import asyncio
import concurrent.futures as cf
from typing import Any, Callable


class ClientExecutor(cf.Executor):
    def __init__(self, client: Any, **submit_kwargs: Any):
        self.client = client
        self.submit_kwargs = submit_kwargs
        self._futures: set = set()
        self._cluster_futures: dict = {}
        self._shutdown = False

    def submit(self, fn: Callable, *args: Any, **kwargs: Any) -> cf.Future:
        if self._shutdown:
            raise RuntimeError("executor has been shut down")
        assert self.client.loop is not None, "client not started"
        merged = {"pure": False, **self.submit_kwargs, **kwargs}
        fut = self.client.submit(fn, *args, **merged)
        cfut: cf.Future = cf.Future()  # stays PENDING: cancel() works
        self._futures.add(cfut)
        self._cluster_futures[cfut] = fut

        async def _relay():
            try:
                result = await fut.result()
            except BaseException as e:  # noqa: B036 - propagate task errors
                if cfut.set_running_or_notify_cancel():
                    cfut.set_exception(e)
            else:
                if cfut.set_running_or_notify_cancel():
                    cfut.set_result(result)
            finally:
                self._futures.discard(cfut)
                self._cluster_futures.pop(cfut, None)

        asyncio.run_coroutine_threadsafe(_relay(), self.client.loop)
        return cfut

    def map(self, fn: Callable, *iterables: Any, timeout: float | None = None,
            chunksize: int = 1) -> Any:
        import time as _time

        futs = [self.submit(fn, *args) for args in zip(*iterables)]
        # stdlib semantics: timeout is an overall deadline, not per-future
        end_time = None if timeout is None else timeout + _time.monotonic()

        def gen():
            for f in futs:
                remaining = (
                    None if end_time is None else end_time - _time.monotonic()
                )
                yield f.result(remaining)

        return gen()

    def shutdown(self, wait: bool = True, *, cancel_futures: bool = False) -> None:
        self._shutdown = True
        if cancel_futures:
            for f in list(self._futures):
                if f.cancel():
                    cluster_fut = self._cluster_futures.pop(f, None)
                    if cluster_fut is not None:
                        cluster_fut.release()
                    self._futures.discard(f)
        if wait:
            cf.wait(list(self._futures), timeout=30)
