"""GroupTiming: time-bucketed cluster compute aggregation
(reference diagnostics/progress.py:344 ``GroupTiming``).

Feeds the dashboard's "compute over time" view: a ring of fixed-width
wall-clock buckets, each accumulating the compute seconds landed by
task completions in that interval, per task prefix.  Unlike spans
(workload-scoped trees) or the task stream (per-task rectangles), this
is the coarse whole-cluster utilization series — O(buckets) memory
regardless of task count.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any

from distributed_tpu_torch.utils.misc import key_split, time, wall_clock


class GroupTimingPlugin:
    name = "group-timing"

    def __init__(self, scheduler: Any, bucket_s: float = 1.0,
                 max_buckets: int = 3600):
        self.scheduler = scheduler
        self.bucket_s = bucket_s
        self.max_buckets = max_buckets
        # ONE clock domain: buckets are indexed by scheduler-side
        # arrival time of the completion.  Worker startstops timestamps
        # are that worker's monotonic clock — epochs are unrelated
        # across hosts, so only their DELTAS (durations) are meaningful
        # here.  t0_wall anchors the series to wall clock for display.
        self.t0 = time()
        self.t0_wall = wall_clock()
        # bucket index -> {prefix: compute seconds}
        self.buckets: dict[int, dict[str, float]] = {}
        scheduler.state.plugins[self.name] = self

    # tape-safe (scheduler/native_engine.py): this hook reads only its
    # arguments, row-current task state and plugin-private structures,
    # never WorkerState.occupancy — so the native engine's applier may
    # replay it per tape row in stream order (docs/native_engine.md)
    tape_safe = True

    def transition(self, key: str, start: str, finish: str, *args: Any,
                   **kwargs: Any) -> None:
        if start != "processing" or finish != "memory":
            return
        seconds = 0.0
        for ss in kwargs.get("startstops") or ():
            if ss.get("action") != "compute":
                continue
            t_start, t_stop = ss.get("start"), ss.get("stop")
            if t_start is not None and t_stop is not None:
                seconds += max(t_stop - t_start, 0.0)
        if not seconds:
            return
        b = int((time() - self.t0) / self.bucket_s)
        bucket = self.buckets.get(b)
        if bucket is None:
            bucket = self.buckets[b] = defaultdict(float)
            self._trim()
        bucket[key_split(key)] += seconds

    def _trim(self) -> None:
        while len(self.buckets) > self.max_buckets:
            del self.buckets[min(self.buckets)]

    def collect(self) -> dict:
        """Series for the dashboard: sorted wall-clock bucket edges +
        per-prefix seconds, ready to stack.  A bucket's value may
        exceed bucket_s x nthreads: a long task lands all its compute
        seconds in its completion bucket."""
        idxs = sorted(self.buckets)
        prefixes: set[str] = set()
        for b in idxs:
            prefixes.update(self.buckets[b])
        return {
            "t0": self.t0_wall,
            "bucket_s": self.bucket_s,
            "edges": [self.t0_wall + b * self.bucket_s for b in idxs],
            "series": {
                p: [self.buckets[b].get(p, 0.0) for b in idxs]
                for p in sorted(prefixes)
            },
        }
