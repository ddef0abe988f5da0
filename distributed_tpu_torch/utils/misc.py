"""General utilities: the part of ``distributed_tpu/utils/misc.py`` that
the control plane reads.

The port's copy of the reference's monotonic ``time()``, ``key_split``,
``funcname``, ``import_term`` and ``seq_name``, line for line.  The rest
of the reference's module (the loop bridge, ``Deadline``, ``log_errors``,
``offload``, the ip/port helpers) serves the servers, which the port does
not have yet.
"""

from __future__ import annotations

import threading
from time import monotonic as time  # noqa: F401  (monotonic clock, like metrics.time)
from time import time as wall_clock  # noqa: F401
from typing import Any


def key_split(key: str) -> str:
    """'x-123-abc' -> 'x'; "('x', 0, 1)" -> 'x'.  Reference: dask.utils.key_split.

    Cached: prefixes are recomputed for the same key at several points
    of a task's life (scheduler group, worker metrics, spans) and the
    string scan is pure."""
    try:
        return _key_split_cache[key]
    except KeyError:
        pass
    except TypeError:  # unhashable (lists in composite keys): compute raw
        return _key_split_uncached(key)
    out = _key_split_uncached(key)
    if len(_key_split_cache) >= 65536:
        _key_split_cache.clear()
    _key_split_cache[key] = out
    return out


_key_split_cache: dict = {}


def _key_split_uncached(key: str) -> str:
    if isinstance(key, bytes):
        key = key.decode()
    if isinstance(key, tuple):
        key = key[0]
    try:
        if key.startswith("('") or key.startswith('("'):
            return key.split(",", 1)[0].strip("('\")")
        words = str(key).split("-")
        # drop trailing uuid/hash/number chunks
        result = [words[0]]
        for w in words[1:]:
            if w.isalpha() and not (len(w) in (8, 16, 32, 40, 64) and _ishex(w)):
                result.append(w)
            else:
                break
        return "-".join(result)
    except Exception:
        return str(key)


def _ishex(s: str) -> bool:
    return all(c in "0123456789abcdef" for c in s)


def funcname(func: Any) -> str:
    while hasattr(func, "func"):
        func = func.func
    return getattr(func, "__name__", str(func))


def import_term(name: str) -> Any:
    """'package.module.ClassName' -> the object."""
    import importlib

    if "." not in name:
        return importlib.import_module(name)
    module_name, attr = name.rsplit(".", 1)
    try:
        module = importlib.import_module(module_name)
        return getattr(module, attr)
    except (ImportError, AttributeError):
        return importlib.import_module(name)


_name_counters: dict[str, int] = {}
_name_lock = threading.Lock()


def seq_name(prefix: str) -> str:
    """Process-unique sequential names: 'Worker-0', 'Worker-1', ..."""
    with _name_lock:
        n = _name_counters.get(prefix, 0)
        _name_counters[prefix] = n + 1
    return f"{prefix}-{n}"
