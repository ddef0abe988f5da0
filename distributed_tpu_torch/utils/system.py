"""Host memory-limit detection: psutil total, capped by cgroups/rlimit.

Fills the reference's ``system.py`` role (``MEMORY_LIMIT`` incl. cgroup
detection): a worker in a container must treat the *container's* memory
ceiling — not the machine's — as its spill/pause/terminate base, or the
kernel OOM-kills it long before the 0.95 terminate threshold fires.

Checked sources, minimum wins:
- total system memory (psutil.virtual_memory().total)
- cgroup v2 ``memory.max`` (unified hierarchy), else cgroup v1
  ``memory.limit_in_bytes``
- ``RLIMIT_RSS`` soft limit, when set
"""

from __future__ import annotations

import os
import sys


def _cgroup_limit() -> int | None:
    """Container memory ceiling in bytes, if one is imposed."""
    if not sys.platform.startswith("linux"):
        return None
    # cgroup v2: the process's own cgroup path under the unified hierarchy
    try:
        with open("/proc/self/cgroup") as f:
            for line in f:
                parts = line.strip().split(":")
                if len(parts) == 3 and parts[0] == "0":
                    path = f"/sys/fs/cgroup{parts[2]}/memory.max"
                    with open(path) as g:
                        raw = g.read().strip()
                    if raw != "max":
                        return int(raw)
    except (OSError, ValueError):
        pass
    # cgroup v1
    try:
        with open("/sys/fs/cgroup/memory/memory.limit_in_bytes") as f:
            value = int(f.read().strip())
        # kernels report "no limit" as a huge page-rounded sentinel
        if value < 2**60:
            return value
    except (OSError, ValueError):
        pass
    return None


def _rlimit() -> int | None:
    try:
        import resource

        soft, _hard = resource.getrlimit(resource.RLIMIT_RSS)
        if soft > 0:
            return soft
    except (ImportError, OSError, ValueError):
        pass
    return None


def memory_limit() -> int:
    """Usable memory for this process, in bytes (reference system.py:11)."""
    import psutil

    limit = psutil.virtual_memory().total
    for cap in (_cgroup_limit(), _rlimit()):
        if cap is not None:
            limit = min(limit, cap)
    return limit


MEMORY_LIMIT = memory_limit()


def outbound_ip(peer_addr: str) -> str:
    """The local interface IP this host uses to reach ``peer_addr``
    (a ``proto://host:port`` address or bare ``host:port``).

    A connected UDP socket never sends a packet; the kernel just picks
    the route, so this works behind NAT/jump setups where the machine's
    own hostname is meaningless to peers (reference utils.py get_ip)."""
    import socket

    host = peer_addr
    if "://" in host:
        host = host.split("://", 1)[1]
    host = host.rsplit(":", 1)[0] or "8.8.8.8"
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        try:
            s.connect((host, 9))
            return s.getsockname()[0]
        except OSError:
            return "127.0.0.1"


def parse_memory_limit(
    value: str | int | None, nworkers: int = 1
) -> int:
    """Worker memory-limit option → bytes (reference worker_memory.py:75).

    ``"auto"`` splits the detected host/container limit over the worker
    processes; ``0``/``None``/``"0"`` disables memory management; a
    float in (0, 1] is a fraction of the detected limit; otherwise a
    byte count, parsed with unit suffixes ("4GiB").
    """
    from distributed_tpu_torch import config

    if value is None:
        return 0
    if value == "auto":
        return MEMORY_LIMIT // max(1, nworkers)
    if isinstance(value, str):
        try:
            value = float(value)
        except ValueError:
            return config.parse_bytes(value)
    if value is True:
        return MEMORY_LIMIT // max(1, nworkers)
    if 0 < value <= 1:
        return int(value * MEMORY_LIMIT)
    return int(value)
