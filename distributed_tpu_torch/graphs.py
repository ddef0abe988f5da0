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


def blockwise_tensordot(G: int):
    """The rechunk + tensordot proxy: G² sources ``s-i-k``, G³ products
    ``m-i-j-k = s-i-k * s-j-k`` (two dependencies each, the same source
    twice when i == j) and G² reductions ``r-i-j`` over k.

    Tasks come in the scheduler's priority order (the depth-first
    postorder of ``graph/order.py`` for these keys): the reductions by
    key, each after its products by key, each product after whichever of
    its sources is not placed yet.  Edges come by consumer in that order,
    each consumer's dependencies in argument order.  Returns
    ``(keys, durations f32[T], out_bytes f32[T], src i32[E], dst i32[E])``
    with every task taking 1 s and writing 8 MB (a 1000 x 1000 f64 block).
    """
    index: dict[str, int] = {}
    src: list[int] = []
    dst: list[int] = []

    def add(key, deps=()):
        index[key] = len(index)
        for d in deps:
            src.append(index[d])
            dst.append(index[key])

    def by_key(keys):
        return sorted(keys, key=lambda ij: "-".join(map(str, ij)))

    for i, j in by_key((i, j) for i in range(G) for j in range(G)):
        for (k,) in by_key((k,) for k in range(G)):
            for s in sorted({f"s-{i}-{k}", f"s-{j}-{k}"}):
                if s not in index:
                    add(s)
            add(f"m-{i}-{j}-{k}", (f"s-{i}-{k}", f"s-{j}-{k}"))
        add(f"r-{i}-{j}", [f"m-{i}-{j}-{k}" for k in range(G)])
    T = len(index)
    return (list(index), np.ones(T, np.float32), np.full(T, 8e6, np.float32),
            np.asarray(src, np.int32), np.asarray(dst, np.int32))
