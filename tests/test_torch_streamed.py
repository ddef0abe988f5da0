"""The port's streamed driver (``place_graph_streamed``) and the scheduler
plan on it (``scheduler/plan.py``) against the JAX reference, on the CPU.

Same inputs (numpy, seeded) at the reference tests' sizes (20k-60k tasks,
8-32 workers, chunks of 6k-9k rows, ``min_stream=1``).

- ``compact=False``: bit-identical (assignment, choice, occupancy, start
  times) to the port's one-shot driver, the reference's streamed driver
  and the reference's one-shot driver.
- ``compact=True``: against the reference's ``compact=True``.  The port's
  decode table is 1 ulp off XLA's on a few codes
  (``test_torch_native.test_decode_table_against_reference``), so the
  test applies the reference's own quality gate unless the table matches.
- ``plan.py``: the hints equal ``JaxPlacement._plan_from_arrays``'s on a
  batch the reference routes to its leveled branch.
"""

from __future__ import annotations

import sys
import threading

import numpy as np
import pytest

from distributed_tpu import config
from distributed_tpu.ops import leveled as jl
from distributed_tpu.scheduler.jax_placement import JaxPlacement
from distributed_tpu_torch import native
from distributed_tpu_torch.ops import leveled as tl
from distributed_tpu_torch.scheduler import plan

from test_leveled import BW, random_dag, workers
from test_torch_native import table_gap_ulps
import torch

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)

FIELDS = ("assignment", "choice", "occupancy", "start_time")


def _mixed(W, seed):
    """Non-uniform: random occupancy, 1-4 threads, a few stopped workers."""
    rng = np.random.default_rng(seed)
    running = np.ones(W, bool)
    running[rng.choice(W, max(W // 8, 1), replace=False)] = False
    return (rng.integers(1, 5, W).astype(np.int32),
            rng.uniform(0, 5, W).astype(np.float32), running)


FLEETS = {
    "uniform": lambda: workers(16),
    "nonuniform": lambda: _mixed(16, 3),
    "stopped": lambda: workers(8, stopped=(2, 5)),
}


def assert_same(got, want):
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field),
                                      err_msg=field)
    assert got.n_waves == want.n_waves
    np.testing.assert_array_equal(got.level, want.level)


def _streamed(graph, fleet, **kw):
    kw.setdefault("min_stream", 1)
    return tl.place_graph_streamed(*graph, *fleet, bandwidth=BW, device="cpu", **kw)


@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_exact_streamed_equals_oneshot_and_reference(fleet):
    """compact=False: tolerance none, against all three drivers."""
    graph = random_dag(np.random.default_rng(11), 40_000)
    nthreads, occ, running = FLEETS[fleet]()
    tm: dict = {}
    packed, got = _streamed(graph, (nthreads, occ, running), compact=False,
                            chunk_rows=7_000, timings=tm)
    assert tm["fmt"] == "f16" and "fallback" not in tm
    assert tm["launches"] >= 2  # waves ran before the last chunk landed
    port_one = tl.place_graph_leveled(tl.pack_graph(*graph, bandwidth=BW),
                                      nthreads, occ, running, device="cpu")
    jpacked = jl.pack_graph(*graph, bandwidth=BW)
    ref_one = jl.place_graph_leveled(jpacked, nthreads, occ, running)
    _, ref_streamed = jl.place_graph_streamed(
        *graph, nthreads, occ, running, bandwidth=BW, compact=False,
        chunk_rows=7_000, min_stream=1,
    )
    for want in (port_one, ref_streamed, ref_one):
        assert_same(got, want)
    for field in ("perm", "offsets", "heavy_s", "xfer_all_s"):
        np.testing.assert_array_equal(getattr(packed, field), getattr(jpacked, field))
    tl.validate_leveled(packed, got, graph[2], graph[3], running)


@pytest.mark.parametrize("n,chunk", [(1025, 4096), (2048, 2048), (4099, 1000), (513, 512)])
def test_chunk_geometry_edge_cases(n, chunk):
    """Chunk above T, equal to T, T just over a power of two, and a last
    chunk of a single row.  Tolerance: none."""
    graph = random_dag(np.random.default_rng(n), n)
    fleet = workers(4)
    _, got = _streamed(graph, fleet, compact=False, chunk_rows=chunk)
    port_one = tl.place_graph_leveled(tl.pack_graph(*graph, bandwidth=BW), *fleet,
                                      device="cpu")
    ref_one = jl.place_graph_leveled(jl.pack_graph(*graph, bandwidth=BW), *fleet)
    _, ref_streamed = jl.place_graph_streamed(
        *graph, *fleet, bandwidth=BW, compact=False, chunk_rows=chunk, min_stream=1,
    )
    for want in (port_one, ref_streamed, ref_one):
        assert_same(got, want)


def test_deep_chain_many_chunks_and_segments():
    """A chain of one-task waves over many chunks: one launch per chunk,
    every segment downloaded, equal to the one-shot driver."""
    n = 6_000
    src = np.arange(n - 1, dtype=np.int32)
    graph = (np.ones(n, np.float32), np.full(n, 1e6, np.float32), src, src + 1)
    tm: dict = {}
    packed, got = _streamed(graph, workers(4), compact=False, chunk_rows=700, timings=tm)
    assert tm["launches"] == -(-n // 700)
    assert_same(got, tl.place_graph_leveled(packed, *workers(4), device="cpu"))


def test_compact_against_reference_compact():
    """compact=True on both sides.  If the port's decode table equals the
    reference's, the results must be bit-identical; it does not (1 ulp on
    a few codes), so this applies the reference's quality gate
    (tests/test_leveled_streamed.py:116-122): imbalance within 15 % + 0.05
    of the reference's and over half the assignments equal."""
    graph = random_dag(np.random.default_rng(12), 60_000)
    fleet = workers(32)
    tm: dict = {}
    packed, got = _streamed(graph, fleet, compact=True, chunk_rows=9_000, timings=tm)
    assert tm["fmt"] == "packed"
    _, want = jl.place_graph_streamed(*graph, *fleet, bandwidth=BW, compact=True,
                                      chunk_rows=9_000, min_stream=1)
    tl.validate_leveled(packed, got, graph[2], graph[3], fleet[2])
    if table_gap_ulps().max() == 0:
        assert_same(got, want)
        return
    W = len(fleet[0])
    c_ref = np.bincount(want.assignment, minlength=W)
    c_got = np.bincount(got.assignment, minlength=W)
    assert c_got.max() / c_got.mean() < c_ref.max() / c_ref.mean() * 1.15 + 0.05
    assert (got.assignment == want.assignment).mean() > 0.5


def test_compact_on_the_cpu_is_the_packed_wire_of_the_plain_wave():
    """The streamed packed run equals a one-shot run of the plain wave
    on the packed wire: chunking changes nothing.  Tolerance: none."""
    graph = random_dag(np.random.default_rng(13), 20_000)
    fleet = _mixed(8, 4)
    packed, got = _streamed(graph, fleet, compact=True, chunk_rows=6_000)
    run = tl.LeveledRun(packed, *fleet, device="cpu", fmt="packed")
    run.run_waves()
    assert_same(got, run.download())


def test_auto_is_f16_on_cpu_and_fallback_below_min_stream():
    graph = random_dag(np.random.default_rng(21), 20_000)
    fleet = workers(8)
    want = tl.place_graph_leveled(tl.pack_graph(*graph, bandwidth=BW), *fleet,
                                  device="cpu")
    tm: dict = {}
    _, got = _streamed(graph, fleet, chunk_rows=6_000, timings=tm)
    assert tm["fmt"] == "f16" and "fallback" not in tm
    assert_same(got, want)
    tm = {}
    _, got = _streamed(graph, fleet, min_stream=1_000_000, timings=tm)
    assert tm["fallback"] is True and tm["fmt"] == "f16"
    assert set(tm) == {"topo_s", "fmt", "fallback", "total_s"}
    assert_same(got, want)


def test_cycle_raises():
    src = np.array([0, 1, 2], np.int32)
    dst = np.array([1, 2, 0], np.int32)
    ones = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="cycle"):
        _streamed((ones, ones, src, dst), workers(2))


def test_fill_failure_raises_and_joins_the_filler(monkeypatch):
    real = native.load()

    class Broken:
        def __getattr__(self, name):
            return getattr(real, name)

        def graphpack_fill(self, i0, *args):
            if i0 > 0:
                raise OSError("fill broke")
            return real.graphpack_fill(i0, *args)

    monkeypatch.setattr(native, "load", lambda: Broken())
    before = threading.active_count()
    graph = random_dag(np.random.default_rng(2), 5_000)
    with pytest.raises(RuntimeError, match="fill failed"):
        _streamed(graph, workers(4), chunk_rows=1_000)
    assert threading.active_count() == before


def test_many_chunks_under_fast_thread_switching():
    """The filler thread and the caller share the row arrays through one
    event a chunk: with a switch interval of 1 us and 40 chunks the
    result still equals the one-shot driver."""
    graph = random_dag(np.random.default_rng(7), 20_000)
    fleet = _mixed(8, 7)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        packed, got = _streamed(graph, fleet, compact=False, chunk_rows=500)
    finally:
        sys.setswitchinterval(interval)
    assert_same(got, tl.place_graph_leveled(tl.pack_graph(*graph, bandwidth=BW), *fleet,
                                            device="cpu"))


# ------------------------------------------------------------------ plan


@pytest.mark.parametrize("streamed", [{}, {"min_stream": 1, "chunk_rows": 6_000}],
                         ids=["reference_defaults", "streamed_branch"])
def test_plan_hints_equal_reference(streamed):
    """The reference routes the batch to its leveled branch (partitioner
    off, no mesh); the port's hints must be the same dict.  With the
    reference's defaults a 20k batch is under ``min_stream`` (pack and
    one-shot on both sides); the second case drives the port's streamed
    branch, which is bit-identical on the CPU's f16 wire."""
    T, W = 20_000, 12
    durations, out_bytes, src, dst = random_dag(np.random.default_rng(31), T)
    nthreads, occ, running = _mixed(W, 31)
    keys = [f"task-{i}" for i in range(T)]
    addrs = [f"tcp://10.0.0.{w}:8788" for w in range(W)]
    args = (keys, durations, out_bytes, src, dst, nthreads, occ, running, addrs,
            BW, 0.0005)
    placement = JaxPlacement(min_batch=4, min_workers=0, sync=True)
    placement.mesh_enabled = False
    with config.set({"scheduler.jax.partitioner": "off"}):
        want, shards = placement._plan_from_arrays(*args)
    assert shards is None
    got = plan.plan_from_arrays(*args, device="cpu", **streamed)
    assert got == want
    assert len(got) == T
    assert any(f is not None for f, _ in got.values())
    assert any(f is None for f, _ in got.values())
