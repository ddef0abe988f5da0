"""The port's sharded leveled engine (``distributed_tpu_torch/ops/sharded.py``)
against the reference's (``distributed_tpu/ops/leveled.py``
``place_graph_leveled_sharded`` on the conftest's 8 virtual XLA CPU
devices), on the CPU.

Tolerance: none, on every layout.  The reference's wave-load ``psum``
reassociates the per-worker sums across shards; XLA's CPU backend adds the
shards' partials one after the other in shard order
(``test_xla_cpu_psum_adds_in_shard_order`` shows it), and the port's
``LocalShards.psum`` adds them in that order, so the port equals the
reference bit for bit at 1x1, 2x1, 4x2 and 8x1 (assignment, choice,
occupancy, start times).  Against the single-device engine the sharded
layouts other than 1x1 are held to ``tests/test_sharded_engine.py``'s gate.

The port's shards run wherever the mesh's devices say: these meshes list
the CPU, once a shard.  ``ProcessGroupShards`` is exercised with two gloo
ranks in their own processes.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from jax import lax
from jax.sharding import PartitionSpec as P

from distributed_tpu.ops import leveled as ref_leveled
from distributed_tpu.ops import partition as ref_partition
from distributed_tpu_torch.ops import leveled, sharded
from distributed_tpu_torch.ops.partition import EngineMesh, make_engine_mesh, shard_bucket

from test_leveled import BW, random_dag, workers
import torch

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
MESH_LAYOUTS = ["1x1", "2x1", "4x2", "8x1"]
FIELDS = ("assignment", "choice", "occupancy", "start_time")


def _size(layout: str) -> int:
    dt, dw = (int(p) for p in layout.split("x"))
    return dt * dw


def cpu_mesh(layout: str) -> EngineMesh:
    return make_engine_mesh(layout=layout, devices=["cpu"] * _size(layout))


def ref_mesh(layout: str):
    if len(jax.devices()) < _size(layout):
        pytest.skip(f"mesh {layout} needs {_size(layout)} devices")
    return ref_partition.make_engine_mesh(layout=layout)


def assert_same(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def both(layout, graph, fleet, **kw):
    """(port, reference) sharded results on the same packed graph."""
    durations, out_bytes, src, dst = graph
    rp = ref_leveled.pack_graph(durations, out_bytes, src, dst, bandwidth=BW)
    pp = leveled.pack_graph(durations, out_bytes, src, dst, bandwidth=BW)
    want = ref_leveled.place_graph_leveled_sharded(ref_mesh(layout), rp, *fleet)
    got = sharded.place_graph_leveled_sharded(cpu_mesh(layout), pp, *fleet, **kw)
    return got, want, pp


def test_xla_cpu_psum_adds_in_shard_order():
    """The reference's psum over 8 virtual CPU devices equals the sum
    ``acc = p[0]; acc = acc + p[1]; ...`` in shard order, bit for bit, and
    not a pairwise tree: that order is what LocalShards reproduces."""
    from distributed_tpu.ops.partition import shard_map_compat

    for layout in ("2x1", "4x2", "8x1"):
        mesh = ref_mesh(layout)
        names, D = mesh.axis_names, mesh.devices.size
        rng = np.random.default_rng(D)
        x = (rng.standard_normal((D, 4096)) * 10.0 ** rng.integers(-4, 5, (D, 4096))).astype(np.float32)
        fn = jax.jit(shard_map_compat(lambda v: lax.psum(v[0], names)[None], mesh=mesh,
                                      in_specs=(P(names),), out_specs=P(names)))
        got = np.asarray(fn(x))[0]
        acc = x[0]
        for d in range(1, D):
            acc = acc + x[d]
        np.testing.assert_array_equal(got, acc)
        tree = list(x)
        while len(tree) > 1:
            tree = [tree[i] + tree[i + 1] for i in range(0, len(tree), 2)]
        if D > 2:
            assert not np.array_equal(got, tree[0])


@pytest.mark.parametrize("layout", MESH_LAYOUTS)
@pytest.mark.parametrize("seed,T,W", [(0, 3000, 16), (1, 12_000, 64)])
def test_lockstep_parity_randomized(layout, seed, T, W):
    """The reference's grid (non-uniform fleets, a stopped worker): the
    port equals the reference's sharded engine bit for bit on every
    layout, and the single-device engine within the reference's gate."""
    rng = np.random.default_rng(seed)
    graph = random_dag(rng, T)
    nthreads, _, running = workers(W, stopped=(2,) if W > 8 else ())
    occ0 = rng.uniform(0, 2.0, W).astype(np.float32)
    fleet = (nthreads, occ0, running)
    got, want, packed = both(layout, graph, fleet)
    assert (got.assignment >= 0).all() and running[got.assignment].all()
    assert_same(got, want)
    single = leveled.place_graph_leveled(packed, *fleet, device="cpu")
    if layout == "1x1":
        assert_same(got, single)
    else:
        assert (got.assignment == single.assignment).mean() > 0.97
        np.testing.assert_allclose(got.occupancy, single.occupancy, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got.start_time, single.start_time, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("layout", ["1x1", "4x2"])
def test_uniform_fleet_takes_uniform_path(layout):
    """A homogeneous idle fleet takes the uniform body (the scalar queue
    cost); equal to the reference bit for bit."""
    rng = np.random.default_rng(3)
    graph = random_dag(rng, 5_000)
    fleet = workers(32)
    got, want, _ = both(layout, graph, fleet)
    assert_same(got, want)


def test_stopped_workers_never_assigned_on_mesh():
    rng = np.random.default_rng(13)
    graph = random_dag(rng, 6_000)
    fleet = workers(16, stopped=(2, 5, 11))
    got, want, _ = both("4x2", graph, fleet)
    assert (got.assignment >= 0).all()
    assert fleet[2][got.assignment].all()
    assert_same(got, want)


def test_shard_bucket_geometry():
    """The reference's cases, and equality on random sizes."""
    assert shard_bucket(0, 8, floor=512) == 512
    assert shard_bucket(4096, 8, floor=512) == 512
    assert shard_bucket(4097, 8, floor=512) == 1024
    assert shard_bucket(4096, 1, floor=512) == 4096
    assert shard_bucket(5, 8, floor=1) == 1
    rng = np.random.default_rng(0)
    for n, d in zip(rng.integers(0, 1 << 22, 200), rng.integers(1, 17, 200)):
        for floor in (1, 512, 2048):
            assert shard_bucket(int(n), int(d), floor) == ref_partition.shard_bucket(int(n), int(d), floor)
        assert shard_bucket(int(n), int(d)) == ref_partition.shard_bucket(int(n), int(d))


@pytest.mark.parametrize("D", [1, 2, 8])
def test_plan_runs_and_pad_equal_reference(D):
    """The fused runs (floor 512, small ``max(SMALL_WAVE // D, 2048)``,
    not shard_bucket's default floor) and the pad past T, on random wave
    offsets."""
    rng = np.random.default_rng(D)
    for _ in range(20):
        sizes = rng.integers(1, rng.choice([50, 5000, 200_000]), rng.integers(1, 40))
        offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
        T = int(offsets[-1])
        want = ref_leveled._plan_runs_sharded(offsets, D)
        got = sharded._plan_runs_sharded(offsets, D)
        assert got == want
        assert sharded.sharded_pad(T, got, offsets, D) == T + ref_leveled._compute_pad(
            T, [(Fl * D, ws) for Fl, ws in want], offsets)


def test_make_engine_mesh_layouts_equal_reference():
    """Auto layout factors near-square with the smaller workers axis, as
    the reference's; TxW takes the first devices; a layout too large for
    the devices raises ValueError; meshes compare by value."""
    for n in range(1, 9):
        got = make_engine_mesh(devices=["cpu"] * n)
        want = ref_partition.make_engine_mesh(n)
        assert (got.dt, got.dw) == tuple(want.devices.shape)
        assert got.shape == {"tasks": want.shape["tasks"], "workers": want.shape["workers"]}
    mesh = make_engine_mesh(layout="4x2", devices=["cpu"] * 10)
    assert (mesh.dt, mesh.dw, mesh.size) == (4, 2, 8) and mesh.axis_names == ("tasks", "workers")
    assert make_engine_mesh(3, devices=["cpu"] * 8).size == 3
    with pytest.raises(ValueError, match="needs 16 devices"):
        make_engine_mesh(layout="8x2", devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="needs 16 devices"):
        ref_partition.make_engine_mesh(layout="8x2")
    assert cpu_mesh("4x2") == cpu_mesh("4x2") and cpu_mesh("4x2") != cpu_mesh("8x1")


def test_sharded_one_by_one_equals_single_engine_uniform():
    rng = np.random.default_rng(5)
    durations, out_bytes, src, dst = random_dag(rng, 8_000)
    packed = leveled.pack_graph(durations, out_bytes, src, dst, bandwidth=BW)
    fleet = workers(24)
    assert_same(sharded.place_graph_leveled_sharded(cpu_mesh("1x1"), packed, *fleet),
                leveled.place_graph_leveled(packed, *fleet, device="cpu"))


def test_streamed_sharded_matches_oneshot_sharded():
    """The streamed driver's mesh branch (runs dispatched while the fill
    runs, tiles from the host fill arrays) equals the one-shot sharded
    engine and the reference's streamed mesh branch, with the f16 wire and
    the same per-shard tile bytes."""
    rng = np.random.default_rng(11)
    durations, out_bytes, src, dst = random_dag(rng, 40_000)
    fleet = workers(16)
    packed = leveled.pack_graph(durations, out_bytes, src, dst, bandwidth=BW)
    one = sharded.place_graph_leveled_sharded(cpu_mesh("4x2"), packed, *fleet)
    tm: dict = {}
    stats: dict = {}
    packed2, res = leveled.place_graph_streamed(
        durations, out_bytes, src, dst, *fleet, bandwidth=BW, chunk_rows=7_000,
        min_stream=1, mesh=cpu_mesh("4x2"), timings=tm, stats=stats,
    )
    assert tm["fmt"] == "f16" and "fallback" not in tm
    assert_same(res, one)
    leveled.validate_leveled(packed2, res, src, dst, fleet[2])
    assert stats["n_shards"] == 8
    per_shard = {row["h2d_bytes"] for row in stats["shards"]}
    assert len(per_shard) == 1 and per_shard.pop() > 0
    ref_stats: dict = {}
    _, want = ref_leveled.place_graph_streamed(
        durations, out_bytes, src, dst, *fleet, bandwidth=BW, chunk_rows=7_000,
        min_stream=1, mesh=ref_mesh("4x2"), stats=ref_stats,
    )
    assert_same(res, want)
    assert stats["runs"] == ref_stats["runs"]
    assert [r["h2d_bytes"] for r in stats["shards"]] == [r["h2d_bytes"] for r in ref_stats["shards"]]


def test_streamed_sharded_fallback_below_threshold():
    """Below min_stream the mesh branch is pack + one-shot sharded place."""
    rng = np.random.default_rng(14)
    durations, out_bytes, src, dst = random_dag(rng, 2_000)
    fleet = workers(8)
    packed = leveled.pack_graph(durations, out_bytes, src, dst, bandwidth=BW)
    res0 = sharded.place_graph_leveled_sharded(cpu_mesh("2x1"), packed, *fleet)
    tm: dict = {}
    _, res1 = leveled.place_graph_streamed(
        durations, out_bytes, src, dst, *fleet, bandwidth=BW, min_stream=1_000_000,
        mesh=cpu_mesh("2x1"), timings=tm,
    )
    assert tm["fallback"] is True
    assert_same(res1, res0)


def test_stats_keys_and_per_shard_bytes():
    rng = np.random.default_rng(2)
    durations, out_bytes, src, dst = random_dag(rng, 3_000)
    packed = leveled.pack_graph(durations, out_bytes, src, dst, bandwidth=BW)
    stats: dict = {}
    sharded.place_graph_leveled_sharded(cpu_mesh("2x1"), packed, *workers(8), stats=stats)
    runs = sharded._plan_runs_sharded(packed.offsets, 2)
    assert stats["n_shards"] == 2 and stats["runs"] == len(runs)
    want = sum(ref_leveled._bucket(len(ws), floor=1) * Fl * 16 for Fl, ws in runs)
    assert [r["h2d_bytes"] for r in stats["shards"]] == [want, want]
    ms = [r["kernel_ms"] for r in stats["shards"]]
    assert ms == sorted(ms) and all(m >= 0 for m in ms)


def test_plain_body_runs_every_layout_through_the_device_rule(monkeypatch):
    """On CPU shards the driver calls the plain pair, never the kernel."""
    calls = []
    monkeypatch.setattr(sharded, "place_shard_cuda", lambda *a, **k: calls.append(a))
    rng = np.random.default_rng(4)
    packed = leveled.pack_graph(*random_dag(rng, 2_000), bandwidth=BW)
    sharded.place_graph_leveled_sharded(cpu_mesh("4x2"), packed, *workers(8))
    assert calls == []


# ------------------------------------------------------ ProcessGroupShards

_RANK = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
sys.path.insert(0, {root!r})
from distributed_tpu_torch import graphs
from distributed_tpu_torch.ops import leveled, sharded
from distributed_tpu_torch.ops.partition import make_engine_mesh
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method="tcp://localhost:{port}", world_size=2, rank=rank)
try:
    mesh = make_engine_mesh(layout="2x1", devices=["cpu", "cpu"])
    packed = leveled.pack_graph(*graphs.random_dag({T}, seed=7))
    W = 24
    running = np.ones(W, bool)
    running[3] = False
    fleet = (np.random.default_rng(1).integers(1, 4, W).astype(np.int32),
             np.random.default_rng(2).uniform(0, 3, W).astype(np.float32), running)
    stats = {{}}
    # the fleet as the mirror's view gives it, one workers-axis block (dw = 1)
    fleet_dev = {{name: [torch.from_numpy(a.copy())]
                 for name, a in zip(("nthreads", "occupancy", "running"), fleet)}}
    res = sharded.place_graph_leveled_sharded(
        mesh, packed, *fleet, comm=sharded.ProcessGroupShards(mesh), stats=stats,
        fleet_dev=fleet_dev)
    np.savez(sys.argv[2], **{{f: getattr(res, f) for f in {fields!r}}})
    print(json.dumps([r["h2d_bytes"] for r in stats["shards"]]))
finally:
    dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_process_group_two_gloo_ranks_equal_local_shards(tmp_path):
    """Two ranks, one shard each, through all_reduce and
    all_gather_into_tensor on gloo (the fleet gathered over the ranks from
    each one's workers-axis block): with two shards the psum is one add,
    which commutes, so each rank's result equals LocalShards 2x1 bit for
    bit.  Each rank runs torch on one thread, under its own time limit."""
    from distributed_tpu_torch import graphs

    T = 6_000
    code = _RANK.format(root=str(ROOT), port=_free_port(), T=T, fields=FIELDS)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(tmp_path / f"r{r}.npz")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    packed = leveled.pack_graph(*graphs.random_dag(T, seed=7))
    W = 24
    running = np.ones(W, bool)
    running[3] = False
    fleet = (np.random.default_rng(1).integers(1, 4, W).astype(np.int32),
             np.random.default_rng(2).uniform(0, 3, W).astype(np.float32), running)
    stats: dict = {}
    want = sharded.place_graph_leveled_sharded(cpu_mesh("2x1"), packed, *fleet, stats=stats)
    for r in range(2):
        got = np.load(tmp_path / f"r{r}.npz")
        for f in FIELDS:
            np.testing.assert_array_equal(got[f], getattr(want, f), err_msg=f"rank {r} {f}")
    # each rank counts only its own shard's tiles
    mine = [row["h2d_bytes"] for row in stats["shards"]]
    assert outs[0] == [mine[0], 0] and outs[1] == [0, mine[1]]
