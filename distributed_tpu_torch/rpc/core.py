"""The scheduler's periodic callback: the part of
``distributed_tpu/rpc/core.py`` that the stealing and AMM extensions
import.

The port's copy of the reference's ``PeriodicCallback`` (``:111``), line
for line.  The rest of the reference's module (the RPC server, the
connection pool) waits for the port's comm (ROADMAP queue 1).
"""

from __future__ import annotations

import asyncio
import inspect
import logging
from collections.abc import Callable

from distributed_tpu_torch.utils import funcname

logger = logging.getLogger("distributed_tpu_torch.rpc")


class PeriodicCallback:
    """asyncio periodic callback (reference compatibility.py)."""

    def __init__(self, callback: Callable, interval_s: float):
        self.callback = callback
        self.interval = interval_s
        self._task: asyncio.Task | None = None

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._run())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    @property
    def is_running(self) -> bool:
        return self._task is not None

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval)
            try:
                res = self.callback()
                if inspect.isawaitable(res):
                    await res
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("periodic callback %s failed", funcname(self.callback))
