"""Carry host-side state from the JAX package's form into the port's.

Both packages keep their placement inputs as numpy arrays, so a
conversion is a check of names, dtypes and shapes; with it the two
engines see bit-identical input in the parity tests.  The data plane's
arrays are global in the reference (sharded over a mesh axis) and lists
of per-shard tensors in the port: :func:`shards_from_numpy` and
:func:`numpy_from_shards` go from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_tpu_torch.ops.leveled import PackedGraph

_PACKED_DTYPES = {
    "perm": np.int32,
    "level": np.int32,
    "offsets": np.int32,
    "duration_s": np.float32,
    "heavy_s": np.int32,
    "heavy2_s": np.int32,
    "xfer_pref_s": np.float32,
    "xfer_pref2_s": np.float32,
    "xfer_all_s": np.float32,
}


def packed_from_numpy(fields: dict, n_levels: int) -> PackedGraph:
    """A ``PackedGraph`` from the reference's fields (e.g. its
    ``PackedGraph._asdict()``); ``n_levels`` may also be in ``fields``."""
    arrays = {}
    for name, dtype in _PACKED_DTYPES.items():
        arr = np.asarray(fields[name])
        if arr.dtype != dtype:
            raise TypeError(f"{name}: expected {np.dtype(dtype)}, got {arr.dtype}")
        arrays[name] = np.ascontiguousarray(arr)
    T = len(arrays["perm"])
    if len(arrays["offsets"]) != n_levels + 1 or arrays["offsets"][-1] != T:
        raise ValueError("offsets must hold n_levels + 1 entries ending at T")
    return PackedGraph(n_levels=int(n_levels), **arrays)


def fleet_from_numpy(nthreads, occupancy0, running):
    """The fleet arrays in the dtypes both engines read: i32, f32, bool."""
    nthreads = np.ascontiguousarray(nthreads, np.int32)
    occupancy0 = np.ascontiguousarray(occupancy0, np.float32)
    running = np.ascontiguousarray(running, bool)
    if not (nthreads.shape == occupancy0.shape == running.shape) or nthreads.ndim != 1:
        raise ValueError("fleet arrays must be 1-D and of one length")
    return nthreads, occupancy0, running


def shards_from_numpy(arr, n_shards: int) -> list[torch.Tensor]:
    """A global array split evenly along its first axis into ``n_shards``
    CPU tensors (copies)."""
    arr = np.ascontiguousarray(arr)
    if arr.shape[0] % n_shards:
        raise ValueError(f"a first axis of {arr.shape[0]} does not split over {n_shards} shards")
    return [torch.from_numpy(c.copy()) for c in np.split(arr, n_shards)]


def numpy_from_shards(parts) -> np.ndarray:
    """The shards joined along their first axis, as the reference's global
    array of the same data reads (``np.asarray`` of it)."""
    return np.concatenate([p.detach().cpu().numpy() for p in parts])
