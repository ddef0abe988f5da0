"""Worker memory management (reference worker_memory.py).

``WorkerMemoryManager`` polls every 100 ms and applies the four-threshold
model (reference distributed.yaml:155-160):

- target   (0.60 of memory_limit): spill by *managed* bytes — evict the
  spill buffer's fast layer down to the budget
- spill    (0.70): spill by *process* memory (RSS)
- pause    (0.80): stop executing / fetching; announce 'paused' to the
  scheduler, which takes the worker out of the running pool
- terminate(0.95): enforced from *outside* the process by the Nanny
  (``NannyMemoryManager``, reference worker_memory.py:368) — the worker
  itself may be too wedged to act.
"""

from __future__ import annotations

import logging
from typing import TYPE_CHECKING, Any

from distributed_tpu_torch import config
from distributed_tpu_torch.rpc.core import PeriodicCallback

if TYPE_CHECKING:
    from distributed_tpu_torch.worker.nanny import Nanny
    from distributed_tpu_torch.worker.server import Worker

logger = logging.getLogger("distributed_tpu_torch.worker.memory")
# the monitor re-evaluates every 100 ms: without a limiter a worker
# camped over the spill threshold logs the same line 10x/s
# (reference utils.py RateLimiterFilter, applied the same way)
from distributed_tpu_torch.utils.misc import RateLimiterFilter  # noqa: E402

logger.addFilter(RateLimiterFilter(r"> spill threshold", rate=10.0))


def _process_rss() -> int:
    try:
        import psutil

        return psutil.Process().memory_info().rss
    except Exception:
        return 0


class WorkerMemoryManager:
    """In-process thresholds: spill / pause (reference worker_memory.py:74)."""

    def __init__(self, worker: "Worker", memory_limit: int):
        self.worker = worker
        self.memory_limit = memory_limit
        mem_cfg = config.get("worker.memory")
        self.target = mem_cfg["target"]
        self.spill = mem_cfg["spill"]
        self.pause = mem_cfg["pause"]
        self.monitor_interval = config.parse_timedelta(
            mem_cfg["monitor-interval"]
        )
        self._paused = False
        self.pc = PeriodicCallback(self.check, self.monitor_interval)
        worker.periodic_callbacks["memory-manager"] = self.pc

    async def check(self) -> None:
        if not self.memory_limit:
            return
        worker = self.worker
        data = worker.data
        # spill by managed memory
        if (
            self.target
            and hasattr(data, "evict")
            and getattr(data, "fast_bytes", 0) > self.target * self.memory_limit
        ):
            await self._spill_to(self.target * self.memory_limit)
        # spill + pause by process memory
        rss = _process_rss()
        frac = rss / self.memory_limit
        if (
            self.spill
            and frac > self.spill
            and hasattr(data, "evict")
            # only if there is actually managed memory left to free —
            # unmanaged RSS pressure can't be spilled and would spam logs
            and getattr(data, "fast_bytes", 0)
            > self.target * self.memory_limit * 0.8
        ):
            logger.info(
                "process memory %.0f%% > spill threshold; spilling", frac * 100
            )
            await self._spill_to(self.target * self.memory_limit * 0.8)
        if self.pause and frac > self.pause and not self._paused:
            self._paused = True
            logger.warning(
                "process memory %.0f%% > pause threshold; pausing worker",
                frac * 100,
            )
            self._set_status("paused")
        elif self._paused and frac < self.pause * 0.95:
            self._paused = False
            logger.info("memory recovered; unpausing worker")
            self._set_status("running")

    async def _spill_to(self, budget: float) -> None:
        data = self.worker.data
        import asyncio

        count = 0
        while getattr(data, "fast_bytes", 0) > budget:
            freed = data.evict()
            if freed < 0:
                break
            count += 1
            if count % 8 == 0:
                await asyncio.sleep(0)  # yield the loop during long spills
        if count:
            logger.info("spilled %d keys to disk", count)

    def _set_status(self, status: str) -> None:
        from distributed_tpu_torch.utils.misc import seq_name
        from distributed_tpu_torch.worker.state_machine import PauseEvent, UnpauseEvent

        worker = self.worker
        stimulus_id = seq_name("memory-monitor")
        # the seq is bumped BEFORE either send path: the stream message
        # and every later heartbeat carry the same ordering stamp
        worker._status_seq += 1
        worker.handle_stimulus(
            PauseEvent(stimulus_id=stimulus_id)
            if status == "paused"
            else UnpauseEvent(stimulus_id=stimulus_id)
        )
        try:
            worker.batched_stream.send(
                {"op": "worker-status-change", "status": status,
                 "status_seq": worker._status_seq,
                 "stimulus_id": stimulus_id}
            )
        except Exception:
            # the batched stream may not exist yet at startup — the pause
            # still applies locally and the next heartbeat reconciles
            logger.debug("status-change send failed (stream not up yet)",
                         exc_info=True)


class NannyMemoryManager:
    """Out-of-process terminate enforcement (reference worker_memory.py:368)."""

    def __init__(self, nanny: "Nanny", memory_limit: int):
        self.nanny = nanny
        self.memory_limit = memory_limit
        mem_cfg = config.get("worker.memory")
        self.terminate = mem_cfg["terminate"]
        self.pc = PeriodicCallback(
            self.check, config.parse_timedelta(mem_cfg["monitor-interval"])
        )
        nanny.periodic_callbacks["memory-manager"] = self.pc

    async def check(self) -> None:
        if not self.memory_limit or not self.terminate:
            return
        process = self.nanny.process
        if process is None or not process.is_alive() or process.pid is None:
            return
        try:
            import psutil

            rss = psutil.Process(process.pid).memory_info().rss
        except Exception:
            return
        if rss > self.terminate * self.memory_limit:
            logger.warning(
                "worker %s rss %.0f MiB exceeded terminate threshold; killing",
                self.nanny.worker_address, rss / 2**20,
            )
            await process.kill()  # exit callback triggers the auto-restart
