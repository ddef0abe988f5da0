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


# ------------------------------------------------ config 2 as a task graph


def tensordot_block(name: str, i: int, k: int, n: int, seed: int, device: str | None):
    """Block ``(i, k)`` of matrix ``name``: an ``n x n`` float32 tensor of
    small integers in [0, 3], drawn from ``(seed, name, i, k)`` on the CPU
    and moved to ``device`` (``"numpy"`` gives the numpy array).  With such
    entries every product and sum of the graph is exact in float32 while
    ``n · 9 · G < 2^24``, so any device and any order of the sums give the
    same bits."""
    import zlib

    import torch

    g = torch.Generator().manual_seed(zlib.crc32(f"{seed}-{name}-{i}-{k}".encode()))
    t = torch.randint(0, 4, (n, n), generator=g, dtype=torch.int32).to(torch.float32)
    if device == "numpy":
        return t.numpy()
    return t if device in (None, "cpu") else t.to(device)


def tensordot_quad(a, qi: int, qj: int):
    h = a.shape[0] // 2
    return a[qi * h : (qi + 1) * h, qj * h : (qj + 1) * h]


def tensordot_assemble(q00, q01, q10, q11):
    if isinstance(q00, np.ndarray):
        return np.block([[q00, q01], [q10, q11]])
    import torch

    return torch.cat([torch.cat([q00, q01], 1), torch.cat([q10, q11], 1)], 0)


def tensordot_mul(a, b):
    return a @ b


def tensordot_add_all(xs):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


def tensordot_graph(G: int, tag: str = "", *, n: int = 4, seed: int = 0,
                    device: str | None = "cpu", classes=None):
    """BASELINE config 2's graph, ``bench.py``'s ``_tensordot_graph``: the
    same keys, dependencies and task order (rechunk every A block into
    quarters and back, then ``C = A' @ B`` blockwise with a fan-in-8 tree
    of sums; ~45,000 tasks at G=32).  Its blocks are
    :func:`tensordot_block`'s seeded small integers where the bench's are
    ``np.full((4, 4), 1.0)``.  ``classes`` is ``(Graph, TaskRef,
    TaskSpec)``, the port's by default.  Returns ``(graph, out_keys)``."""
    if classes is None:
        from distributed_tpu_torch.graph.spec import Graph, TaskRef, TaskSpec
    else:
        Graph, TaskRef, TaskSpec = classes
    g = Graph()
    for i in range(G):
        for k in range(G):
            g.tasks[f"A{tag}-{i}-{k}"] = TaskSpec(tensordot_block, ("A", i, k, n, seed, device))
            g.tasks[f"B{tag}-{i}-{k}"] = TaskSpec(tensordot_block, ("B", i, k, n, seed, device))
    for i in range(G):
        for k in range(G):
            for qi in range(2):
                for qj in range(2):
                    g.tasks[f"Aq{tag}-{i}-{k}-{qi}{qj}"] = TaskSpec(
                        tensordot_quad, (TaskRef(f"A{tag}-{i}-{k}"), qi, qj))
            g.tasks[f"Ar{tag}-{i}-{k}"] = TaskSpec(
                tensordot_assemble,
                tuple(TaskRef(f"Aq{tag}-{i}-{k}-{qi}{qj}") for qi in range(2) for qj in range(2)))
    outs = []
    for i in range(G):
        for j in range(G):
            for k in range(G):
                g.tasks[f"mul{tag}-{i}-{j}-{k}"] = TaskSpec(
                    tensordot_mul, (TaskRef(f"Ar{tag}-{i}-{k}"), TaskRef(f"B{tag}-{k}-{j}")))
            level = [f"mul{tag}-{i}-{j}-{k}" for k in range(G)]
            r = 0
            while len(level) > 1:
                nxt = []
                for b in range(0, len(level), 8):
                    key = f"red{tag}-{i}-{j}-{r}-{b}"
                    g.tasks[key] = TaskSpec(tensordot_add_all, ([TaskRef(x) for x in level[b : b + 8]],))
                    nxt.append(key)
                level, r = nxt, r + 1
            outs.append(level[0])
    return g, outs


def tensordot_expected(G: int, *, n: int = 4, seed: int = 0) -> np.ndarray:
    """``[G, G, n, n]``: block (i, j) of ``C = A @ B`` from
    :func:`tensordot_block`'s blocks, in numpy (float64, exact here)."""
    A = [[tensordot_block("A", i, k, n, seed, "numpy").astype(np.float64) for k in range(G)]
         for i in range(G)]
    B = [[tensordot_block("B", i, k, n, seed, "numpy").astype(np.float64) for k in range(G)]
         for i in range(G)]
    return np.stack([np.stack([sum(A[i][k] @ B[k][j] for k in range(G)) for j in range(G)])
                     for i in range(G)])


# ------------------------------------------------ config 1 as a task graph


def ones_block(shape, device: str | None = "cpu"):
    """A block of float64 ones on ``device`` (CUDA for None)."""
    import torch

    return torch.ones(shape, dtype=torch.float64, device="cuda" if device is None else device)


def block_sum(a) -> float:
    return float(a.sum())


def sum_list(xs):
    return sum(xs)


def array_sum_graph(*, grid: int = 10, block: int = 1000, fanin: int = 8,
                    device: str | None = "cpu", classes=None):
    """BASELINE config 1's graph, ``bench.py``'s ``cfg_array_sum``: the
    same keys, dependencies and task order (``ones((10000, 10000),
    chunks=1000).sum()``: ``grid²`` blocks of ``block x block`` ones, a sum
    of each, then a fan-in-``fanin`` tree of sums).  The blocks are torch
    tensors on ``device`` where the bench's are numpy arrays; every sum is
    exact in float64, so the root is ``(grid · block)²`` on any device.
    ``classes`` is ``(Graph, TaskRef, TaskSpec)``, the port's by default.
    Returns ``(graph, root_key, block_keys)``."""
    if classes is None:
        from distributed_tpu_torch.graph.spec import Graph, TaskRef, TaskSpec
    else:
        Graph, TaskRef, TaskSpec = classes
    g = Graph()
    partials, blocks = [], []
    for i in range(grid):
        for j in range(grid):
            ck = f"ones-{i}-{j}"
            g.tasks[ck] = TaskSpec(ones_block, ((block, block), device))
            sk = f"sum-{i}-{j}"
            g.tasks[sk] = TaskSpec(block_sum, (TaskRef(ck),))
            partials.append(sk)
            blocks.append(ck)
    level, r = partials, 0
    while len(level) > 1:
        nxt = []
        for b in range(0, len(level), fanin):
            k = f"agg-{r}-{b}"
            g.tasks[k] = TaskSpec(sum_list, ([TaskRef(x) for x in level[b : b + fanin]],))
            nxt.append(k)
        level, r = nxt, r + 1
    return g, level[0], blocks


# ------------------------------------------------ config 3's task


def slowinc(i, x=0, delay=0.02):
    """``bench.py``'s ``_slowinc``: sleeps ``delay`` s, returns ``i + x``."""
    import time

    time.sleep(delay)
    return i + x
