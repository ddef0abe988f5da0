"""SpillBuffer: dict-like store that overflows to disk (reference spill.py).

Fast layer = in-memory dict with LRU ordering; slow layer = one pickled
file per key in the worker's scratch directory (the reference composes
zict Buffer/File/Func, spill.py:69 — same semantics, no dependency).
``evict()`` moves the least-recently-used fast key to disk; reads from
slow promote back to fast.  Byte accounting feeds the worker memory
manager's spill decisions.
"""

from __future__ import annotations

import logging
import os
import pickle
import shutil
import tempfile
from collections.abc import Iterator, MutableMapping
from typing import Any

from distributed_tpu_torch.utils.sizeof import safe_sizeof

logger = logging.getLogger("distributed_tpu_torch.spill")


class SpillBuffer(MutableMapping):
    """{key: value} with a byte-bounded fast layer (reference spill.py:69)."""

    def __init__(self, spill_directory: str | None = None, target: int = 0,
                 metrics_cb=None):
        # metrics_cb(label, value, unit): fine-metrics sink — the worker
        # wires this so serialize/disk-write/disk-read seconds and bytes
        # show up per activity in spans / performance_report (reference
        # metrics.py captures these inside its spill brackets)
        self.metrics_cb = metrics_cb
        self.spill_directory = spill_directory or tempfile.mkdtemp(
            prefix="dtpu-spill-"
        )
        os.makedirs(self.spill_directory, exist_ok=True)
        self.target = target  # fast-layer byte budget; 0 = unbounded
        self.fast: dict[str, Any] = {}  # insertion order = LRU order
        self.fast_sizes: dict[str, int] = {}
        self.fast_bytes = 0
        self.slow: dict[str, int] = {}  # key -> file size
        self.slow_bytes = 0
        # cumulative metrics (reference spill.py SpillBuffer.cumulative_metrics)
        self.spilled_count = 0
        self.unspilled_count = 0

    # ----------------------------------------------------------- mapping API

    def __setitem__(self, key: str, value: Any) -> None:
        # plain delete, NOT MutableMapping.pop — pop would round-trip a
        # stale slow-layer value through disk+unpickle just to discard it
        try:
            del self[key]
        except KeyError:
            pass
        size = safe_sizeof(value)
        self.fast[key] = value
        self.fast_sizes[key] = size
        self.fast_bytes += size
        if self.target:
            while self.fast_bytes > self.target and len(self.fast) > 1:
                if self.evict() < 0:
                    break

    def __getitem__(self, key: str) -> Any:
        if key in self.fast:
            # LRU touch: move to the back
            value = self.fast.pop(key)
            self.fast[key] = value
            return value
        if key in self.slow:
            value = self._unspill(key)
            return value
        raise KeyError(key)

    def __delitem__(self, key: str) -> None:
        if key in self.fast:
            del self.fast[key]
            self.fast_bytes -= self.fast_sizes.pop(key)
        elif key in self.slow:
            self.slow_bytes -= self.slow.pop(key)
            try:
                os.unlink(self._path(key))
            except OSError:
                pass
        else:
            raise KeyError(key)

    def __contains__(self, key: object) -> bool:
        return key in self.fast or key in self.slow

    def __iter__(self) -> Iterator[str]:
        yield from self.fast
        yield from self.slow

    def __len__(self) -> int:
        return len(self.fast) + len(self.slow)

    # ------------------------------------------------------------- spilling

    def _path(self, key: str) -> str:
        safe = key.replace(os.sep, "_").replace("\x00", "_")[:150]
        return os.path.join(self.spill_directory, f"{safe}-{abs(hash(key)):x}")

    def evict(self) -> int:
        """Spill the least-recently-used fast key; returns bytes freed or -1
        (reference spill.py:150 / worker_memory evict loop)."""
        if not self.fast:
            return -1
        key = next(iter(self.fast))
        from distributed_tpu_torch.utils.misc import time as _now

        t0 = _now()
        try:
            # no local holds the value: a frame object of this call (the
            # worker's sampling profiler takes them) keeps its locals after
            # the return, and a spilled CUDA tensor would stay on the card
            payload = pickle.dumps(self.fast[key], protocol=5)
        except Exception:
            # unpicklable: keep in fast but move to the back so we don't
            # spin on it
            v = self.fast.pop(key)
            self.fast[key] = v
            logger.warning("cannot spill unpicklable key %r", key)
            return -1
        t1 = _now()
        with open(self._path(key), "wb") as f:
            f.write(payload)
        if self.metrics_cb is not None:
            self.metrics_cb("serialize", t1 - t0, "seconds")
            self.metrics_cb("disk-write", _now() - t1, "seconds")
            self.metrics_cb("disk-write", float(len(payload)), "bytes")
        del self.fast[key]
        size = self.fast_sizes.pop(key)
        self.fast_bytes -= size
        self.slow[key] = len(payload)
        self.slow_bytes += len(payload)
        self.spilled_count += 1
        return size

    def _unspill(self, key: str) -> Any:
        from distributed_tpu_torch.utils.misc import time as _now

        t0 = _now()
        with open(self._path(key), "rb") as f:
            payload = f.read()
        t1 = _now()
        value = pickle.loads(payload)
        if self.metrics_cb is not None:
            self.metrics_cb("disk-read", t1 - t0, "seconds")
            self.metrics_cb("disk-read", float(len(payload)), "bytes")
            self.metrics_cb("deserialize", _now() - t1, "seconds")
        self.slow_bytes -= self.slow.pop(key)
        try:
            os.unlink(self._path(key))
        except OSError:
            pass
        size = safe_sizeof(value)
        self.fast[key] = value
        self.fast_sizes[key] = size
        self.fast_bytes += size
        self.unspilled_count += 1
        return value

    def close(self) -> None:
        shutil.rmtree(self.spill_directory, ignore_errors=True)

    def __repr__(self) -> str:
        return (
            f"<SpillBuffer fast={len(self.fast)} ({self.fast_bytes}B) "
            f"slow={len(self.slow)} ({self.slow_bytes}B)>"
        )
