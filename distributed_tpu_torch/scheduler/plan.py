"""The scheduler's placement plan on the leveled engine.

The counterpart of the leveled branch of
``distributed_tpu/scheduler/jax_placement.py::JaxPlacement._plan_from_arrays``
(without its mesh branch): the streamed driver places the batch, and each
placed task becomes a hint ``key -> (follow_key | None, addr)`` that
``decide_worker`` consumes.

A locality choice (the task went with its heaviest or second-heaviest
dependency) is encoded FOLLOW-THIS-DEPENDENCY: the hint names the
dependency's key, so the consumer finds that dependency's current holder
and a hint survives upstream drift.  A spread placement keeps the planned
address.  Tasks placed on no worker get no hint.
"""

from __future__ import annotations

import numpy as np

from distributed_tpu_torch.ops.leveled import (
    LeveledResult,
    PackedGraph,
    place_graph_streamed,
)


def hints_from_placement(keys, packed: PackedGraph, result: LeveledResult,
                         addrs) -> dict:
    """``{key: (follow_key | None, addr)}`` for every placed task."""
    assignment = result.assignment
    nw = len(addrs)
    n = len(keys)
    inv = np.empty(max(n, 1), np.int32)
    inv[packed.perm] = np.arange(n, dtype=np.int32)
    hs = packed.heavy_s[inv[:n]]
    h2s = packed.heavy2_s[inv[:n]]
    horig = np.where(hs >= 0, packed.perm[np.maximum(hs, 0)], -1)
    h2orig = np.where(h2s >= 0, packed.perm[np.maximum(h2s, 0)], -1)
    follow = np.where(
        result.choice == 0, horig,
        np.where(result.choice == 1, h2orig, -1),
    )
    return {
        key: (
            keys[int(follow[i])] if follow[i] >= 0 else None,
            addrs[int(assignment[i])],
        )
        for i, key in enumerate(keys)
        if 0 <= assignment[i] < nw
    }


def plan_from_arrays(keys, durations, out_bytes, src, dst, nthreads, occupancy,
                     running, addrs, bandwidth, transfer_latency=0.0,
                     device=None, **streamed) -> dict:
    """Place a batch and return its hints.

    The arguments are the reference's: ``keys[i]`` names task i,
    ``src[e] -> dst[e]`` are dependency edges between batch indices,
    the fleet arrays and ``addrs`` are per worker.  ``device=None`` means
    CUDA; ``streamed`` passes on to :func:`place_graph_streamed`
    (``timings=``, or the chunking for tests), whose defaults are those
    the reference plans with.
    """
    packed, result = place_graph_streamed(
        durations, out_bytes, src, dst, nthreads, occupancy, running,
        bandwidth=bandwidth, latency=transfer_latency, device=device, **streamed,
    )
    return hints_from_placement(keys, packed, result, addrs)
