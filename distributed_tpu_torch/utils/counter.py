"""Counter + Digest sketches for metrics (reference counter.py).

``Digest`` records streaming samples (task latencies, transfer times,
tick durations) and answers quantile queries — backed by the native C++
t-digest (``distributed_tpu_torch.native``) like the reference's optional
crick TDigest (counter.py:7,40).

The port's copy of ``distributed_tpu/utils/counter.py``.  It builds the
port's own ``native/tdigest.cpp`` at first use and raises when it cannot,
where the reference falls back to a sorted-sample list (kept below, but
never taken: ``_handle`` is always set).
"""

from __future__ import annotations

import ctypes
import threading
from collections import defaultdict
from typing import Iterable


class Counter:
    """Tally of discrete observations (reference counter.py:16)."""

    def __init__(self):
        self.counts: defaultdict = defaultdict(int)
        self.n = 0

    def add(self, item) -> None:
        self.counts[item] += 1
        self.n += 1

    def update(self, items: Iterable) -> None:
        for item in items:
            self.add(item)

    def most_common(self, k: int | None = None):
        out = sorted(self.counts.items(), key=lambda kv: -kv[1])
        return out if k is None else out[:k]


class Digest:
    """Streaming quantile sketch (reference counter.py:40)."""

    def __init__(self, compression: float = 100.0, *, block_on_build: bool = False):
        from distributed_tpu_torch import native

        # the port's own t-digest library, built at first use (the port
        # has no event loop yet that a compile here could stall); a
        # build that fails raises
        self._lib = native.load_tdigest()
        self._handle = None
        self._fallback: list[float] | None = None
        self.compression = compression
        # hot-path buffer: a ctypes call RELEASES the GIL, so one FFI
        # call per sample makes every digest_metric on the event loop
        # wait to reacquire it behind the executor threads (sampled at
        # 42% of main-thread CPU on the config-2 bench).  add() only
        # appends (atomic under the GIL — user task code reaches add()
        # from executor threads via context_meter); flushes swap the
        # buffer and run the FFI under _flush_lock so two racing
        # flushes can neither double-count one buffer nor run two
        # add_batch calls on the same native handle concurrently.
        self._pending: list[float] = []
        self._flush_lock = threading.Lock()
        if self._lib is not None:
            self._handle = self._lib.tdigest_new(compression)
        else:
            self._fallback = []

    @property
    def native(self) -> bool:
        return self._handle is not None

    def add(self, x: float, weight: float = 1.0) -> None:
        if weight == 1.0:
            # append under the lock: a lock-free append could land on a
            # list a racing flush has already swapped out and fed to the
            # FFI (sample silently lost).  Uncontended acquire stays in
            # C and never drops the GIL — the cost being avoided here is
            # the per-sample ctypes call, not the lock.
            with self._flush_lock:
                self._pending.append(x)
                n = len(self._pending)
            if n >= 4096:
                self._flush()
            return
        with self._flush_lock:
            self._flush_locked()
            if self._handle is not None:
                self._lib.tdigest_add(self._handle, float(x), float(weight))
            else:
                self._fallback.extend([float(x)] * max(1, round(weight)))
                if len(self._fallback) > 100_000:  # bound the fallback
                    self._fallback = sorted(self._fallback)[::2]

    def _flush(self) -> None:
        if not self._pending:
            return
        with self._flush_lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        # a sample appended between the swap's load and store lands in
        # the captured list and is flushed; appends after the store go
        # to the fresh buffer — nothing is lost or double-counted
        pending, self._pending = self._pending, []
        if not pending:
            return
        if self._handle is not None:
            import numpy as np

            arr = np.ascontiguousarray(pending, dtype=np.float64)
            self._lib.tdigest_add_batch(
                self._handle,
                arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                len(arr),
            )
        else:
            self._fallback.extend(float(x) for x in pending)
            if len(self._fallback) > 100_000:
                self._fallback = sorted(self._fallback)[::2]

    def add_batch(self, xs) -> None:
        if self._handle is not None:
            import numpy as np

            arr = np.ascontiguousarray(xs, dtype=np.float64)
            with self._flush_lock:
                self._flush_locked()
                self._lib.tdigest_add_batch(
                    self._handle,
                    arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                    len(arr),
                )
        else:
            for x in xs:
                self.add(x)

    def quantile(self, q: float) -> float:
        # the whole read runs under the lock: native "reads" compact the
        # centroid buffers first (TDigest::flush sorts/merges), so a
        # concurrent add_batch on the same handle would race in C++
        with self._flush_lock:
            self._flush_locked()
            if self._handle is not None:
                return self._lib.tdigest_quantile(self._handle, float(q))
            data = sorted(self._fallback)
        if not data:
            return float("nan")
        idx = min(len(data) - 1, max(0, int(q * (len(data) - 1))))
        return data[idx]

    def count(self) -> float:
        with self._flush_lock:
            self._flush_locked()
            if self._handle is not None:
                return self._lib.tdigest_count(self._handle)
            return float(len(self._fallback))

    def min(self) -> float:
        with self._flush_lock:
            self._flush_locked()
            if self._handle is not None:
                return self._lib.tdigest_min(self._handle)
            return min(self._fallback) if self._fallback else float("nan")

    def max(self) -> float:
        with self._flush_lock:
            self._flush_locked()
            if self._handle is not None:
                return self._lib.tdigest_max(self._handle)
            return max(self._fallback) if self._fallback else float("nan")

    def serialize(self) -> bytes:
        """Centroid array as bytes, mergeable on another node."""
        if self._handle is not None:
            with self._flush_lock:
                self._flush_locked()
                need = self._lib.tdigest_serialize(self._handle, None, 0)
                buf = (ctypes.c_double * need)()
                self._lib.tdigest_serialize(self._handle, buf, need)
                return bytes(bytearray(buf))
        self._flush()
        if self._handle is None:
            import struct

            # uniform stride over the sorted samples, with aggregate
            # weights, so the merged distribution keeps both tails
            # instead of only the 1000 smallest values
            full = sorted(self._fallback)
            stride = -(-len(full) // 1000)  # ceil: at most 1000 samples
            data = full[::stride] if full else []
            if data and data[-1] != full[-1]:
                data.append(full[-1])  # keep the maximum (upper tail)
            weight = len(full) / len(data) if data else 1.0
            return struct.pack(f"<d{len(data) * 2}d", float(len(data)),
                               *sum(([x, weight] for x in data), []))
        raise AssertionError("unreachable: native path handled above")

    def merge_serialized(self, payload: bytes) -> None:
        n = len(payload) // 8
        buf = (ctypes.c_double * n).from_buffer_copy(payload)
        if self._handle is not None:
            with self._flush_lock:
                self._lib.tdigest_merge_serialized(self._handle, buf, n)
        else:
            vals = list(buf)
            count = int(vals[0]) if vals else 0
            for i in range(count):
                if 2 + 2 * i < len(vals):
                    self.add(vals[1 + 2 * i], vals[2 + 2 * i])

    def __del__(self):
        if getattr(self, "_handle", None) is not None and self._lib is not None:
            try:
                self._lib.tdigest_free(self._handle)
            except Exception:
                pass
            self._handle = None

    def __repr__(self) -> str:
        return (
            f"<Digest n={self.count():.0f} native={self.native} "
            f"compression={self.compression}>"
        )
