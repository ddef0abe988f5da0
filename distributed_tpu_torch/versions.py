"""Version handshake: detect mismatched environments early
(reference versions.py).

Every node reports python + key package versions; the client compares
them and surfaces mismatches (the classic source of pickle
incompatibilities across a cluster).

The port's copy of ``distributed_tpu/versions.py``; the one seam is the
package list: the port reports numpy, torch and psutil, where the
reference reports numpy, msgpack, cloudpickle, jax and psutil (the port
imports none of the three).
"""

from __future__ import annotations

import platform
import sys
from typing import Any

_PACKAGES = ["numpy", "torch", "psutil"]


def get_versions() -> dict[str, Any]:
    out: dict[str, Any] = {
        "python": ".".join(map(str, sys.version_info[:3])),
        "platform": platform.system(),
        "machine": platform.machine(),
    }
    from distributed_tpu_torch import __version__

    out["distributed_tpu_torch"] = __version__
    for name in _PACKAGES:
        try:
            mod = __import__(name)
            out[name] = getattr(mod, "__version__", "unknown")
        except ImportError:
            out[name] = None
    return out


def version_mismatches(info: dict[str, Any]) -> dict[str, dict]:
    """{package: {node: version}} for packages that differ across nodes."""
    nodes: dict[str, dict] = {"client": info.get("client", {}),
                              "scheduler": info.get("scheduler", {})}
    for addr, v in (info.get("workers") or {}).items():
        if isinstance(v, dict):
            nodes[addr] = v
    mismatches: dict[str, dict] = {}
    keys = {k for v in nodes.values() for k in v}
    for key in keys:
        values = {n: v.get(key) for n, v in nodes.items() if v}
        if len(set(values.values())) > 1:
            mismatches[key] = values
    return mismatches
