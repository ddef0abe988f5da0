"""Pickle shim: protocol-5 out-of-band buffers.

Equivalent of the reference's ``distributed/protocol/pickle.py``: plain
pickle first (fast, C implementation) with a ``buffer_callback`` collecting
zero-copy out-of-band buffers.  The reference falls back to cloudpickle for
what pickle cannot handle (lambdas, closures, interactively-defined
functions); the port imports no cloudpickle (the card's machine has none),
so it always takes the reference's branch for a missing cloudpickle, and a
task function must be an importable module-level function.
"""

from __future__ import annotations

import pickle
from typing import Any

cloudpickle = None  # the reference's branch where the import fails (:14-17)

HIGHEST_PROTOCOL = pickle.HIGHEST_PROTOCOL


def dumps(x: Any, *, buffer_callback=None) -> bytes:
    """Pickle with the best available serializer for ``x``.

    Buffers collect locally and reach ``buffer_callback`` only after a
    serializer SUCCEEDS: plain pickle may emit out-of-band buffers for
    early objects and then raise on a later unpicklable one — handing
    those stale buffers to the caller would misalign them against the
    cloudpickle stream's own full set and silently shift every
    out-of-band payload at load time."""
    buffers: list = []
    try:
        data = pickle.dumps(x, protocol=5, buffer_callback=buffers.append)
    except Exception:
        buffers.clear()
        if cloudpickle is None:
            raise
        data = cloudpickle.dumps(x, protocol=5, buffer_callback=buffers.append)
    if buffer_callback is not None:
        for b in buffers:
            buffer_callback(b)
    return data


def loads(data: bytes, *, buffers=()) -> Any:
    return pickle.loads(data, buffers=buffers)
