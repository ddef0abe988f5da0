"""MemorySampler: record cluster-wide memory over the lifetime of a
computation (reference diagnostics/memory_sampler.py:180).

    ms = MemorySampler()
    async with ms.sample("run1", client=c, interval=0.2):
        ... run the workload ...
    ms.to_list("run1")   # [(t_offset_seconds, total_bytes), ...]
"""

from __future__ import annotations

import asyncio
import contextlib
from typing import Any, AsyncIterator

from distributed_tpu_torch.utils.misc import time


class MemorySampler:
    def __init__(self) -> None:
        self.samples: dict[str, list[tuple[float, int]]] = {}

    @contextlib.asynccontextmanager
    async def sample(self, label: str = "", *, client: Any,
                     interval: float = 0.5,
                     measure: str = "managed") -> AsyncIterator[None]:
        """Poll total cluster memory every ``interval`` seconds while the
        block runs.  ``measure``: "managed" (scheduler-tracked nbytes) or
        "rss" (workers' process memory from heartbeats)."""
        label = label or f"sample-{len(self.samples)}"
        out = self.samples[label] = []
        t0 = time()
        stop = asyncio.Event()

        async def poll() -> None:
            while not stop.is_set():
                try:
                    total = await client.scheduler.memory_sample(
                        measure=measure
                    )
                    out.append((time() - t0, int(total)))
                except Exception:
                    pass
                try:
                    await asyncio.wait_for(stop.wait(), interval)
                except asyncio.TimeoutError:
                    pass

        task = asyncio.create_task(poll())
        try:
            yield
        finally:
            stop.set()
            await task

    def to_list(self, label: str) -> list[tuple[float, int]]:
        return list(self.samples[label])

    def max(self, label: str) -> int:
        return max((v for _, v in self.samples[label]), default=0)


async def memory_sample_handler(scheduler: Any, measure: str = "managed",
                                **kwargs: Any) -> int:
    """Scheduler handler backing MemorySampler."""
    if measure == "rss":
        return sum(
            (ws.metrics.get("host") or {}).get("memory", 0)
            if ws.metrics else 0
            for ws in scheduler.state.workers.values()
        )
    return sum(ws.nbytes for ws in scheduler.state.workers.values())
