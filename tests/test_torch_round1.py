"""The port's round-1 batched placers (``ops/placement.py``,
``ops/wavefront.py``, ``parallel/mesh.py``) against the reference's on the
same numpy inputs, the reference on the conftest's 8 virtual XLA CPU
devices, the port on the CPU (``LocalShards`` for the mesh).

Tolerance: none.  Every result equals the reference's bit for bit: the
f32 sums add in index order on both sides (XLA's CPU scatter-add; the
port's ``index_add_`` on the CPU and ``segment_sum_in_order``), the
argmins share the (cost, nbytes, index) order, and the sorts are stable.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from distributed_tpu.ops import placement as ref_placement
from distributed_tpu.ops import wavefront as ref_wavefront
from distributed_tpu.parallel import mesh as ref_mesh
from distributed_tpu_torch import graphs
from distributed_tpu_torch.ops import comm, placement, wavefront
from distributed_tpu_torch.parallel import mesh

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)

BW = 100e6
LAYOUTS = ("1x1", "2x1", "4x2", "8x1")
needs_mesh = pytest.mark.skipif(jax.device_count() < 8, reason="needs the 8-device CPU mesh")


def problem(seed, B=50, W=8, D=30, E=120, restrict_frac=0.0, ties=False):
    """Host arrays of one placement batch (``tests/test_placement.py``'s
    ``random_problem``); ``ties`` draws occupancy, threads, nbytes and dep
    sizes from two values each, so costs and nbytes tie across workers."""
    rng = np.random.default_rng(seed)
    if ties:
        occ = rng.choice([0.0, 2.0], W).astype(np.float32)
        threads = rng.choice([1, 2], W).astype(np.int32)
        wnbytes = rng.choice([0.0, 1e6], W).astype(np.float32)
        dep_bytes = rng.choice([1e6, 4e6], D).astype(np.float32)
    else:
        occ = rng.uniform(0, 5, W).astype(np.float32)
        threads = rng.integers(1, 5, W).astype(np.int32)
        wnbytes = rng.uniform(0, 1e9, W).astype(np.float32)
        dep_bytes = rng.uniform(1e3, 1e8, D).astype(np.float32)
    running = rng.random(W) >= 0.2
    running[0] = True
    durations = rng.uniform(0.001, 1.0, B).astype(np.float32)
    has = rng.random((D, W)) < 0.3
    edge_task = rng.integers(0, B, E).astype(np.int32)
    edge_dep = rng.integers(0, D, E).astype(np.int32)
    restrict = None
    if restrict_frac:
        restrict = np.ones((B, W), bool)
        for i in np.flatnonzero(rng.random(B) < restrict_frac):
            restrict[i] = rng.random(W) < 0.4
    return dict(workers=(threads, occ, wnbytes, running),
                batch=(durations, (edge_task, edge_dep), dep_bytes, has, restrict))


def both(p):
    """The reference's (WorkerArrays, PlacementBatch) and the port's, from
    the same host arrays."""
    threads, occ, wnbytes, running = p["workers"]
    durations, edges, dep_bytes, has, restrict = p["batch"]
    ref = (ref_placement.WorkerArrays(*(jnp.asarray(x) for x in p["workers"])),
           ref_placement.build_batch_arrays(durations, edges, dep_bytes, has, restrict=restrict))
    port = (placement.WorkerArrays(*p["workers"]).to("cpu"),
            placement.build_batch_arrays(durations, edges, dep_bytes, has, restrict=restrict,
                                         device="cpu"))
    return ref, port


def same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.reshape(-1).view(np.uint8), want.reshape(-1).view(np.uint8))


CASES = [dict(seed=s) for s in range(3)] + [
    dict(seed=10, ties=True), dict(seed=11, ties=True, B=200, W=16, E=300),
    dict(seed=100, restrict_frac=0.5), dict(seed=101, restrict_frac=0.5, ties=True),
    dict(seed=7, B=100), dict(seed=3, B=10), dict(seed=12, B=40, E=0),
]


@pytest.mark.parametrize("sequential", [True, False])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_decide_workers_equals_reference(case, sequential):
    (rw, rb), (pw, pb) = both(problem(**case))
    want_a, want_occ = ref_placement.decide_workers(rw, rb, BW, sequential=sequential)
    got_a, got_occ = placement.decide_workers(pw, pb, BW, sequential=sequential, device="cpu")
    same(got_a, want_a)
    same(got_occ, want_occ)


@pytest.mark.parametrize("case", CASES[:4], ids=str)
def test_missing_bytes_and_candidates_equal_reference(case):
    (rw, rb), (pw, pb) = both(problem(**case))
    same(placement.missing_bytes_matrix(pb), ref_placement.missing_bytes_matrix(rb))
    same(placement.candidate_mask(pb, pw), ref_placement.candidate_mask(rb, rw))


def test_segment_sum_in_order_adds_in_index_order():
    """Each segment's sum is ((0 + x0) + x1) + ... in index order, not a
    tree: values picked so that another order rounds differently."""
    data = torch.tensor([1.0, 2.0 ** -24, 2.0 ** -24, 5.0, 2.0 ** -24], dtype=torch.float32)
    seg = torch.tensor([0, 0, 0, 1, 0])
    want = torch.zeros(2)
    for x, s in zip(data, seg):
        want[s] += x
    got = placement.segment_sum_in_order(data, seg, 2)
    assert torch.equal(got, want) and got[0] == 1.0  # each tiny add rounds away


@pytest.mark.parametrize("n", [0, 1, 160, 200, 255])
@pytest.mark.parametrize("fleet", [0, 1])
def test_place_rootish_equals_reference(n, fleet):
    if fleet == 0:
        threads = np.array([2, 2, 2, 2, 4, 4, 1, 1], np.int32)
        running = np.ones(8, bool)
        running[3] = False
    else:
        rng = np.random.default_rng(5)
        threads = rng.integers(0, 5, 37).astype(np.int32)
        running = rng.random(37) < 0.7
    workers = (threads, np.zeros(len(threads), np.float32), np.zeros(len(threads), np.float32),
               running)
    want = ref_placement.place_rootish(jnp.int32(n), ref_placement.WorkerArrays(
        *(jnp.asarray(x) for x in workers)), max_tasks=256)
    got = placement.place_rootish(n, placement.WorkerArrays(*workers), max_tasks=256, device="cpu")
    same(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_occupancy_after_finish_equals_reference(seed):
    rng = np.random.default_rng(seed)
    W, F = 16, 300
    occ = rng.uniform(0, 50, W).astype(np.float32)
    threads = rng.integers(1, 4, W).astype(np.int32)
    fw = rng.integers(-1, W, F).astype(np.int32)
    fd = rng.uniform(0, 3, F).astype(np.float32)
    want = ref_placement.occupancy_after_finish(*(jnp.asarray(x) for x in (occ, threads, fw, fd)))
    same(placement.occupancy_after_finish(occ, threads, fw, fd, device="cpu"), want)


# ------------------------------------------------------------ wavefront


def _chain(n=50):
    src = np.arange(n - 1, dtype=np.int64)
    return (np.ones(n, np.float32), np.full(n, 1e6, np.float32), src, src + 1,
            dict(pad_tasks=n + 1, pad_edges=n))


def _mapreduce(width=64, reducers=8):
    n = width + reducers + 1
    per = width // reducers
    src = [i for r in range(reducers) for i in range(r * per, (r + 1) * per)] + \
        [width + r for r in range(reducers)]
    dst = [width + r for r in range(reducers) for _ in range(per)] + [width + reducers] * reducers
    return (np.ones(n, np.float32), np.full(n, 1e6, np.float32), np.asarray(src, np.int64),
            np.asarray(dst, np.int64), dict(pad_tasks=n + 7, pad_edges=len(src) + 5))


def _random(n, seed=0):
    dur, ob, src, dst = graphs.random_dag(n, seed=seed)
    return dur, ob, src.astype(np.int64), dst.astype(np.int64), \
        dict(pad_tasks=ref_placement.pad_to_bucket(n), pad_edges=ref_placement.pad_to_bucket(len(src)))


def _fleet(W, seed, uniform):
    rng = np.random.default_rng(seed)
    if uniform:
        return np.full(W, 2, np.int32), np.zeros(W, np.float32), np.ones(W, bool)
    running = np.ones(W, bool)
    running[: W // 8] = False
    return (rng.integers(1, 5, W).astype(np.int32), rng.uniform(0, 5, W).astype(np.float32),
            running)


GRAPHS = {"chain": _chain, "mapreduce": _mapreduce, "random3000": lambda: _random(3000),
          "random20000": lambda: _random(20_000, seed=1)}


@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_place_graph_equals_reference(graph, uniform):
    dur, ob, src, dst, pad = GRAPHS[graph]()
    fleet = _fleet(16, 3, uniform)
    rg = ref_wavefront.GraphArrays.from_arrays(dur, ob, src, dst, **pad)
    want = ref_wavefront.place_graph(rg, *(jnp.asarray(x) for x in fleet), bandwidth=BW,
                                     chunk_waves=8)
    pg = wavefront.GraphArrays.from_arrays(dur, ob, src, dst, **pad, device="cpu")
    for f in pg._fields:
        same(getattr(pg, f), getattr(rg, f))
    got = wavefront.place_graph(pg, *fleet, bandwidth=BW, chunk_waves=8)
    for f in want._fields:
        same(getattr(got, f), getattr(want, f))
    wavefront.validate_placement(pg, got, fleet[2])


def test_validate_placement_rejects_a_consumer_in_its_producers_wave():
    dur, ob, src, dst, pad = _mapreduce()
    g = wavefront.GraphArrays.from_arrays(dur, ob, src, dst, **pad, device="cpu")
    fleet = _fleet(8, 0, True)
    res = wavefront.place_graph(g, *fleet)
    wavefront.validate_placement(g, res, fleet[2])
    bad = res._replace(wave_of=res.wave_of.clone().fill_(0))
    with pytest.raises(AssertionError, match="no later"):
        wavefront.validate_placement(g, bad, fleet[2])
    stopped = fleet[2].copy()
    stopped[int(res.assignment[0])] = False
    with pytest.raises(AssertionError, match="non-running"):
        wavefront.validate_placement(g, res, stopped)


# ------------------------------------------------------------ sharded (K15)


K15_CASES = [dict(seed=42, B=64, W=16, D=32, E=200),
             dict(seed=43, B=64, W=16, D=32, E=200, restrict_frac=0.3),
             dict(seed=44, B=64, W=16, D=32, E=200, ties=True)]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", K15_CASES, ids=str)
def test_sharded_decide_workers_equals_reference(layout, case):
    """The reference's own check (``tests/test_placement.py:278-285``): the
    sharded assignment equals the single-device parallel one.  Here the
    port's at every layout equals the reference's single-device assignment
    and the port's."""
    (rw, rb), (pw, pb) = both(problem(**case))
    want, _ = ref_placement.decide_workers(rw, rb, BW, sequential=False)
    got = mesh.sharded_decide_workers(mesh.make_mesh(devices=["cpu"] * 8, layout=layout), pw, pb, BW)
    same(got, want)
    port_single, _ = placement.decide_workers(pw, pb, BW, sequential=False, device="cpu")
    same(got, port_single)


@needs_mesh
def test_sharded_decide_workers_equals_the_reference_sharded():
    """Against the reference's own ``sharded_decide_workers`` (a shard_map
    build a call, ~8 s: one layout, the restricted case)."""
    (rw, rb), (pw, pb) = both(problem(**K15_CASES[1]))
    dt, dw = 4, 2
    ref = Mesh(np.asarray(jax.devices()[: dt * dw]).reshape(dt, dw), ("tasks", "workers"))
    want = ref_mesh.sharded_decide_workers(ref, rw, rb, BW)
    same(mesh.sharded_decide_workers(mesh.make_mesh(devices=["cpu"] * 8, layout="4x2"), pw, pb, BW),
         want)


def test_sharded_decide_workers_on_one_rank_per_shard_equals_local():
    """The comm interface's other holder: each shard alone (as one rank of a
    process group holds it) computes the same picks as ``LocalShards``."""
    (_, _), (pw, pb) = both(problem(seed=45, B=64, W=16, D=32, E=200, restrict_frac=0.3))
    pmesh = mesh.make_mesh(devices=["cpu"] * 8, layout="4x2")
    want = mesh.sharded_decide_workers(pmesh, pw, pb, BW)

    class OneShard(comm.LocalShards):
        """Shard ``r`` alone; its gathers read the other shards' parts from
        a full ``LocalShards`` run of the same call."""

        def __init__(self, m, r, parts_of):
            super().__init__(m)
            self.local, self.parts_of = [r], parts_of

        def all_gather(self, parts):
            full = self.parts_of.pop(0)
            full[self.local[0]] = parts[0]
            return torch.cat(full)

    calls = []

    class Recording(comm.LocalShards):
        def all_gather(self, parts):
            calls.append([p.clone() for p in parts])
            return super().all_gather(parts)

    mesh.sharded_decide_workers(pmesh, pw, pb, BW, comm=Recording(pmesh))
    for r in range(8):
        got = mesh.sharded_decide_workers(pmesh, pw, pb, BW,
                                          comm=OneShard(pmesh, r, [list(c) for c in calls]))
        same(got, want)


def test_sharded_rejects_indivisible_tiles():
    (_, _), (pw, pb) = both(problem(seed=1, B=50, W=9))
    with pytest.raises(ValueError, match="divisible"):
        mesh.sharded_decide_workers(mesh.make_mesh(devices=["cpu"] * 8, layout="4x2"),
                                    pw, pb, BW)


def test_make_mesh_factors_like_the_reference():
    for n in (1, 2, 4, 6, 8):
        got = mesh.make_mesh(devices=["cpu"] * n)
        want = ref_mesh.make_mesh(n)
        assert (got.dt, got.dw) == (want.shape["tasks"], want.shape["workers"])


def test_parallel_exports_are_lazy():
    import importlib
    import subprocess
    import sys

    code = ("import sys, distributed_tpu_torch.parallel as p, distributed_tpu_torch.parallel.multihost;"
            "assert 'distributed_tpu_torch.parallel.mesh' not in sys.modules;"
            "assert p.make_mesh.__module__ == 'distributed_tpu_torch.parallel.mesh';"
            "assert p.ring_attention.__module__ == 'distributed_tpu_torch.ops.ring_attention';"
            "print(sorted(p.__all__))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    parallel = importlib.import_module("distributed_tpu_torch.parallel")
    assert sorted(parallel.__all__) == sorted(importlib.import_module("distributed_tpu.parallel").__all__)
    with pytest.raises(AttributeError):
        parallel.no_such_export  # noqa: B018


def test_leveled_sharded_alias_is_the_engine():
    from distributed_tpu_torch.ops import leveled, partition

    packed = leveled.pack_graph(*graphs.random_dag(500, seed=0))
    fleet = (np.full(16, 2, np.int32), np.zeros(16, np.float32), np.ones(16, bool))
    pm = partition.make_engine_mesh(layout="2x1", devices=["cpu"] * 2)
    a, load = mesh.place_graph_leveled_sharded(pm, packed, *fleet)
    from distributed_tpu_torch.ops import sharded

    res = sharded.place_graph_leveled_sharded(pm, packed, *fleet)
    assert np.array_equal(a, res.assignment) and np.array_equal(load, res.occupancy)
