"""Seeded random task graphs for tests and ``chip_smoke.py``."""

from __future__ import annotations

import numpy as np


def random_dag(n: int, seed=0):
    """Random DAG of ``n`` tasks: task i depends on up to two uniformly
    random earlier tasks (task 0 has none).

    ``seed`` is an int or a ``numpy.random.Generator``.  Returns
    ``(durations f32[n], out_bytes f32[n], src i32[E], dst i32[E])`` with
    ``src[e] -> dst[e]`` meaning dst depends on src; the draws are the
    same, in the same order, as the reference benchmark's 1M-task graph.
    """
    rng = np.random.default_rng(seed)
    durations = rng.uniform(0.01, 1.0, n).astype(np.float32)
    out_bytes = rng.uniform(1e3, 1e7, n).astype(np.float32)
    n_deps = rng.integers(0, 3, n)
    n_deps[0] = 0
    dst = np.repeat(np.arange(n), n_deps).astype(np.int32)
    src = (rng.random(len(dst)) * np.maximum(dst, 1)).astype(np.int32)
    return durations, out_bytes, src, dst
