"""SystemMonitor: periodic host metrics sampling (reference system_monitor.py:18).

Samples cpu/memory/network/disk every 500 ms into fixed-length ring
buffers; the latest sample ships with worker heartbeats and feeds the
Prometheus collectors and ``/info`` routes.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Any

from distributed_tpu_torch.utils.misc import time

logger = logging.getLogger("distributed_tpu_torch.system_monitor")

# process-global psutil sample cache: /proc reads (disk_io_counters in
# particular) cost milliseconds, and an in-process LocalCluster runs one
# monitor per worker — without sharing, N monitors make N identical
# psutil sweeps per interval.  Rates (bps) are computed HERE from the
# cache's own sample-to-sample dt: monitors polling faster than the TTL
# would otherwise see zero deltas then stale deltas over their private
# dt (0, 0, 3x oscillation).
_HOST_TTL = 1.0
_host_lock = threading.Lock()
_host_cache: dict[str, Any] = {"t": -1e9}


def _sample_host() -> dict[str, Any]:
    now = time()
    with _host_lock:
        if now - _host_cache["t"] > _HOST_TTL:
            net = SystemMonitor._net_counters()
            disk = SystemMonitor._disk_counters()
            prev_t = _host_cache["t"]
            dt = now - prev_t
            if "net" in _host_cache and dt < 10 * _HOST_TTL:
                pnet, pdisk = _host_cache["net"], _host_cache["disk"]
                _host_cache["net_read_bps"] = (net[0] - pnet[0]) / dt
                _host_cache["net_write_bps"] = (net[1] - pnet[1]) / dt
                _host_cache["disk_read_bps"] = (disk[0] - pdisk[0]) / dt
                _host_cache["disk_write_bps"] = (disk[1] - pdisk[1]) / dt
            else:
                _host_cache["net_read_bps"] = _host_cache["net_write_bps"] = 0.0
                _host_cache["disk_read_bps"] = _host_cache["disk_write_bps"] = 0.0
            _host_cache["net"] = net
            _host_cache["disk"] = disk
            _host_cache["cpu"], _host_cache["mem"] = _proc_stats()
            _host_cache["t"] = now
        return dict(_host_cache)


_proc = None


def _proc_stats() -> tuple[float, int]:
    global _proc
    try:
        if _proc is None:
            import psutil

            _proc = psutil.Process()
            _proc.cpu_percent()  # prime the interval sampler
        return _proc.cpu_percent(), _proc.memory_info().rss
    except Exception:
        return 0.0, 0


class SystemMonitor:
    def __init__(self, maxlen: int = 7200):
        self.maxlen = maxlen
        self.quantities: dict[str, deque] = {
            "cpu": deque(maxlen=maxlen),
            "memory": deque(maxlen=maxlen),
            "time": deque(maxlen=maxlen),
            "host_net_io.read_bps": deque(maxlen=maxlen),
            "host_net_io.write_bps": deque(maxlen=maxlen),
            "host_disk_io.read_bps": deque(maxlen=maxlen),
            "host_disk_io.write_bps": deque(maxlen=maxlen),
        }
        self.count = 0
        _sample_host()  # prime the shared cache

    @staticmethod
    def _net_counters():
        try:
            import psutil

            c = psutil.net_io_counters()
            return (c.bytes_recv, c.bytes_sent)
        except Exception:
            return (0, 0)

    @staticmethod
    def _disk_counters():
        try:
            import psutil

            c = psutil.disk_io_counters()
            if c is None:
                return (0, 0)
            return (c.read_bytes, c.write_bytes)
        except Exception:
            return (0, 0)

    def update(self) -> dict[str, Any]:
        """Take one sample; returns it (reference system_monitor.py:141)."""
        now = time()
        host = _sample_host()
        sample = {
            "time": now,
            "cpu": host["cpu"],
            "memory": host["mem"],
            "host_net_io.read_bps": host["net_read_bps"],
            "host_net_io.write_bps": host["net_write_bps"],
            "host_disk_io.read_bps": host["disk_read_bps"],
            "host_disk_io.write_bps": host["disk_write_bps"],
        }
        for k, v in sample.items():
            self.quantities[k].append(v)
        self.count += 1
        return sample

    def recent(self) -> dict[str, Any]:
        return {
            k: (q[-1] if q else 0) for k, q in self.quantities.items()
        }

    def range_query(self, start: int = 0) -> dict[str, list]:
        istart = max(0, start - (self.count - len(self.quantities["time"])))
        return {
            "count": self.count,
            **{k: list(q)[istart:] for k, q in self.quantities.items()},
        }
