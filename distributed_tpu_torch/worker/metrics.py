"""Fine-grained performance metrics (reference metrics.py:159 ContextMeter).

``context_meter.meter("label")`` brackets a block and reports its wall
seconds to every callback installed on the current (context-local)
stack; ``digest_metric`` reports arbitrary (label, value, unit) samples,
e.g. transferred bytes.  The worker installs a callback around each
activity (execute / gather-dep / get-data) that files samples under
``(context, span_id, prefix, label, unit)`` — shipped to the scheduler
with heartbeats and aggregated onto spans (reference metrics.py:336,
spans.py cumulative_worker_metrics).

User task code can emit custom samples too:

    from distributed_tpu_torch.worker.metrics import context_meter
    with context_meter.meter("my-phase"):
        ...
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Callable, Iterator

from distributed_tpu_torch.utils.misc import time


class ContextMeter:
    def __init__(self) -> None:
        self._cbs: contextvars.ContextVar[tuple[Callable, ...]] = (
            contextvars.ContextVar("dtpu_meter_cbs", default=())
        )

    @contextlib.contextmanager
    def add_callback(self, cb: Callable[[str, float, str], None]) -> Iterator[None]:
        token = self._cbs.set(self._cbs.get() + (cb,))
        try:
            yield
        finally:
            self._cbs.reset(token)

    def digest_metric(self, label: str, value: float, unit: str = "seconds") -> None:
        for cb in self._cbs.get():
            try:
                cb(label, value, unit)
            except Exception:  # metrics must never break the data path
                pass

    @contextlib.contextmanager
    def meter(self, label: str) -> Iterator[None]:
        t0 = time()
        try:
            yield
        finally:
            self.digest_metric(label, time() - t0, "seconds")


context_meter = ContextMeter()


class FineMetrics:
    """Per-worker accumulator: cumulative totals plus a since-last-
    heartbeat delta buffer (reference worker.py
    digests_total_since_heartbeat)."""

    def __init__(self) -> None:
        self.total: dict[tuple, float] = {}
        self.since_heartbeat: dict[tuple, float] = {}

    def add(self, context: str, span_id: str | None, prefix: str,
            label: str, unit: str, value: float) -> None:
        key = (context, span_id or "", prefix, label, unit)
        self.total[key] = self.total.get(key, 0.0) + value
        self.since_heartbeat[key] = self.since_heartbeat.get(key, 0.0) + value

    def take(self) -> dict[tuple, float]:
        """Pop the heartbeat delta; pair with restore() on send failure."""
        out = self.since_heartbeat
        self.since_heartbeat = {}
        return out

    def restore(self, delta: dict[tuple, float]) -> None:
        """Merge a failed heartbeat's delta back in (samples must never
        be lost to a transient comm error)."""
        for k, v in delta.items():
            self.since_heartbeat[k] = self.since_heartbeat.get(k, 0.0) + v

    @staticmethod
    def rows(delta: dict[tuple, float]) -> list[list[Any]]:
        """msgpack-friendly encoding of a delta."""
        return [[*k, v] for k, v in delta.items()]


class DelayedMetricsLedger:
    """Metrics collector for one ASYNC instruction (reference
    metrics.py:336 DelayedMetricsLedger).

    A gather-dep or execute spans many event-loop iterations; samples
    produced while it runs (network reads, deserialize, disk writes)
    must be attributed to THAT instruction even though other coroutines
    interleave.  ``activity()`` installs a context-local callback (so
    only awaits on this coroutine's context record here), and
    ``finalize`` files everything plus the un-metered remainder as
    ``other`` — the time the instruction spent scheduled but not inside
    any bracket (loop contention, executor queueing).
    """

    def __init__(self, sink: Callable[[str, float, str], None]):
        self._sink = sink
        self.samples: list[tuple[str, float, str]] = []
        self.start = time()

    def record(self, label: str, value: float, unit: str) -> None:
        self.samples.append((label, value, unit))

    @contextlib.contextmanager
    def activity(self) -> Iterator[None]:
        with context_meter.add_callback(self.record):
            yield

    def finalize(self, other_label: str = "other") -> None:
        elapsed = time() - self.start
        metered = sum(
            v for _, v, unit in self.samples if unit == "seconds"
        )
        for label, value, unit in self.samples:
            self._sink(label, value, unit)
        remainder = elapsed - metered
        if remainder > 0:
            self._sink(other_label, remainder, "seconds")
