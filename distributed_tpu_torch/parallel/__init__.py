"""Parallelism over meshes of shards, PyTorch port.

``mesh`` builds the ``(tasks, workers)`` scheduler mesh and the sharded
placement step; ``multihost`` brings up a process group.  Sequence
parallelism lives in ``ops`` (``ring_attention``, ``ulysses``,
``flash``), re-exported here as in the reference.  Every export is lazy:
importing ``distributed_tpu_torch.parallel.multihost`` pulls in no
placement code.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "make_mesh": "distributed_tpu_torch.parallel.mesh",
    "sharded_decide_workers": "distributed_tpu_torch.parallel.mesh",
    "ring_attention": "distributed_tpu_torch.ops.ring_attention",
    "ulysses_attention": "distributed_tpu_torch.ops.ulysses",
    "flash_attention": "distributed_tpu_torch.ops.flash",
}


def __getattr__(name: str):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module 'distributed_tpu_torch.parallel' has no attribute {name!r}")


__all__ = list(_EXPORTS)
