"""The port's leveled placement engine against the JAX reference on CPU.

Same inputs (numpy, seeded) go through ``distributed_tpu.ops.leveled``
and ``distributed_tpu_torch.ops.leveled``; the port's plain wave body
must reproduce the reference's assignment and choice exactly, and its
float outputs within rtol 1e-6, on the graph families of
tests/test_leveled.py in uniform and non-uniform fleets.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from distributed_tpu.ops import leveled as jl
from distributed_tpu_torch import graphs
from distributed_tpu_torch.convert import fleet_from_numpy, packed_from_numpy
from distributed_tpu_torch.ops import leveled as tl

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)

BW = 100e6


def _random(n, seed):
    return graphs.random_dag(n, seed=seed)


def _chain(n=50):
    src = np.arange(n - 1, dtype=np.int32)
    return np.ones(n, np.float32), np.full(n, 1e6, np.float32), src, src + 1


def _mapreduce(width=64, reducers=8):
    n = width + reducers + 1
    per = width // reducers
    src = [i for r in range(reducers) for i in range(r * per, (r + 1) * per)]
    dst = [width + r for r in range(reducers) for _ in range(per)]
    src += [width + r for r in range(reducers)]
    dst += [width + reducers] * reducers
    return (np.ones(n, np.float32), np.full(n, 1e6, np.float32),
            np.asarray(src, np.int32), np.asarray(dst, np.int32))


def _wide(n_roots=4):
    n_leaves = jl.SMALL_WAVE * 2 + 17  # one wave far above SMALL_WAVE
    n = n_roots + n_leaves
    dst = np.arange(n_roots, n, dtype=np.int32)
    return (np.ones(n, np.float32), np.full(n, 1e3, np.float32),
            (dst % n_roots).astype(np.int32), dst)


def _no_edges(n):
    return (np.ones(n, np.float32), np.zeros(n, np.float32),
            np.zeros(0, np.int32), np.zeros(0, np.int32))


def _fleet(W, threads=2, stopped=(), occ=None):
    running = np.ones(W, bool)
    running[list(stopped)] = False
    occ = np.zeros(W, np.float32) if occ is None else occ
    return fleet_from_numpy(np.full(W, threads, np.int32), occ, running)


def _mixed_fleet(W, seed):
    """Non-uniform: random occupancy, 1-4 threads, a few stopped workers."""
    rng = np.random.default_rng(seed)
    running = np.ones(W, bool)
    running[rng.choice(W, max(W // 8, 1), replace=False)] = False
    return fleet_from_numpy(
        rng.integers(1, 5, W), rng.uniform(0, 5, W).astype(np.float32), running
    )


CASES = {
    "chain": (lambda: _chain(), lambda: _fleet(4)),
    "mapreduce": (lambda: _mapreduce(), lambda: _fleet(8)),
    "random_uniform": (lambda: _random(5000, 4), lambda: _fleet(16)),
    "random_nonuniform": (lambda: _random(5000, 5), lambda: _mixed_fleet(16, 5)),
    "stopped": (lambda: _random(800, 3), lambda: _fleet(8, stopped=(2, 5))),
    "occupancy": (
        lambda: _no_edges(1000),
        lambda: _fleet(4, occ=np.asarray([1e6, 0, 0, 0], np.float32)),
    ),
    "wide_uniform": (lambda: _wide(), lambda: _fleet(8)),
    "wide_nonuniform": (lambda: _wide(), lambda: _mixed_fleet(8, 1)),
    # F x W above 2^31: the spread slot must come from block division,
    # and the codes no longer fit int16 (the wide download)
    "fleet_over_int32": (lambda: _no_edges(70000), lambda: _fleet(32768)),
    "deep_mixed": (lambda: _random(20000, 7), lambda: _mixed_fleet(64, 7)),
}


def _both(graph, fleet):
    durations, out_bytes, src, dst = graph
    jpacked = jl.pack_graph(durations, out_bytes, src, dst, bandwidth=BW)
    packed = packed_from_numpy(jpacked._asdict(), jpacked.n_levels)
    want = jl.place_graph_leveled(jpacked, *fleet)
    got = tl.place_graph_leveled(packed, *fleet, device="cpu")
    return packed, want, got


@pytest.mark.parametrize("case", sorted(CASES))
def test_placement_matches_reference_exactly(case):
    make_graph, make_fleet = CASES[case]
    graph, fleet = make_graph(), make_fleet()
    packed, want, got = _both(graph, fleet)
    np.testing.assert_array_equal(got.assignment, want.assignment)
    np.testing.assert_array_equal(got.choice, want.choice)
    np.testing.assert_allclose(got.occupancy, want.occupancy, rtol=1e-6)
    np.testing.assert_allclose(got.start_time, want.start_time, rtol=1e-6)
    assert got.n_waves == want.n_waves
    np.testing.assert_array_equal(got.level, want.level)
    _, _, src, dst = graph
    tl.validate_leveled(packed, got, src, dst, fleet[2])


def test_uniform_flag_follows_fleet():
    assert tl._worker_params(*_fleet(8))[1] is True
    assert tl._worker_params(*_fleet(8, stopped=(1,)))[1] is False
    assert tl._worker_params(*_mixed_fleet(8, 0))[1] is False


def test_first_wave_spread_follows_stable_order():
    """Wave 0 ties every sort key: a stable sort spreads priority-
    contiguous blocks over workers 0, 1, 2, ... in index order."""
    W, n = 16, 100
    packed = tl.pack_graph(*_no_edges(n))
    res = tl.place_graph_leveled(packed, *_fleet(W), device="cpu")
    block = -(-n // W)
    np.testing.assert_array_equal(res.assignment, np.arange(n) // block)
    assert (res.choice == 2).all()


def test_every_row_written_exactly_once():
    """No padding waves: the waves' slices partition the sorted rows."""
    durations, out_bytes, src, dst = _random(3000, 11)
    packed = tl.pack_graph(durations, out_bytes, src, dst)
    run = tl.LeveledRun(packed, *_fleet(8), device="cpu")
    writes = np.zeros(packed.n, np.int64)

    def counting(r, wave):
        before = r.assign.clone()
        tl.place_wave_reference(r, wave)
        changed = (r.assign != before).numpy()
        lo, f = r.wave_bounds(wave)
        assert not changed[:lo].any() and not changed[lo + f:].any()
        writes[lo: lo + f] += 1

    run.run_waves(counting)
    np.testing.assert_array_equal(writes, 1)
    assert (run.assign >= 0).all()


def test_wave_dispatch_is_by_device():
    packed = tl.pack_graph(*_chain(8))
    run = tl.LeveledRun(packed, *_fleet(2), device="cpu")
    before = tl.place_waves_cuda.launches
    tl.place_wave(run, 0)
    assert tl.place_waves_cuda.launches == before  # CPU: the plain version
    assert run.assign[0] >= 0
    with pytest.raises(RuntimeError, match="CUDA"):
        tl.place_wave_cuda(run, 1)


# ------------------------------------------------------------------ pack


PACK_GRAPHS = {
    "random": lambda: _random(3000, 1),
    "chain": lambda: _chain(),
    "mapreduce": lambda: _mapreduce(),
}


@pytest.mark.parametrize("name", sorted(PACK_GRAPHS))
def test_pack_matches_reference(name):
    durations, out_bytes, src, dst = PACK_GRAPHS[name]()
    want = jl.pack_graph(durations, out_bytes, src, dst, bandwidth=BW)
    got = tl.pack_graph(durations, out_bytes, src, dst, bandwidth=BW)
    assert got.n_levels == want.n_levels
    for field in ("level", "perm", "offsets", "heavy_s", "heavy2_s", "duration_s"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    for field in ("xfer_pref_s", "xfer_pref2_s", "xfer_all_s"):
        np.testing.assert_allclose(
            getattr(got, field), getattr(want, field), rtol=1e-6, atol=0
        )


def test_pack_cycle_and_empty():
    with pytest.raises(ValueError, match="cycle"):
        tl.pack_graph(np.ones(3, np.float32), np.ones(3, np.float32),
                      np.asarray([0, 1, 2], np.int32), np.asarray([1, 2, 0], np.int32))
    p = tl.pack_graph(*_no_edges(1))
    assert p.n_levels == 1 and p.offsets.tolist() == [0, 1]


def test_plan_runs_and_bucket_match_reference():
    offsets = np.cumsum([0, 10, 20, 30, 40, 50, jl.SMALL_WAVE * 3, 10, 10,
                         70000, 90000, 5]).astype(np.int32)
    assert tl._plan_runs(offsets) == jl._plan_runs(offsets)
    for n in (0, 1, 511, 512, 513, 100000):
        assert tl._bucket(n) == jl._bucket(n)


def test_random_dag_matches_reference_generator():
    from test_leveled import random_dag

    want = random_dag(np.random.default_rng(9), 4000)
    got = graphs.random_dag(4000, seed=9)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_convert_checks_fields():
    jpacked = jl.pack_graph(*_chain(10))
    fields = jpacked._asdict()
    packed = packed_from_numpy(fields, jpacked.n_levels)
    assert packed.n == 10
    bad = dict(fields, heavy_s=fields["heavy_s"].astype(np.int64))
    with pytest.raises(TypeError):
        packed_from_numpy(bad, jpacked.n_levels)
    with pytest.raises(ValueError):
        packed_from_numpy(fields, jpacked.n_levels + 1)
    with pytest.raises(ValueError):
        fleet_from_numpy(np.ones(3), np.zeros(2), np.ones(3, bool))


def test_kernel_scratch_fits_the_widest_wave():
    packed = tl.pack_graph(*_wide())
    run = tl.LeveledRun(packed, *_fleet(8), device="cpu")
    sc = run.kernel_scratch(132)
    widest = int(np.diff(packed.offsets).max())
    assert sc.tgt.numel() == sc.wt.numel() == sc.sorted.numel() == widest
    assert sc.cnt.numel() == 132 * 8  # one count per (worker, block)
    assert run.kernel_scratch(132) is sc
    assert run.kernel_scratch(66).cnt.numel() == 66 * 8


def test_codes_round_trip():
    packed = tl.pack_graph(*_random(500, 2))
    run = tl.LeveledRun(packed, *_fleet(8), device="cpu")
    run.run_waves()
    assert run.codes().dtype == torch.int16
    res = run.download()
    sorted_assign = run.assign.numpy()
    np.testing.assert_array_equal(res.assignment[packed.perm], sorted_assign)


# ------------------------------------------------------ whole-graph entry


@pytest.mark.parametrize("case", sorted(CASES))
def test_whole_graph_entry_equals_per_wave_path(case):
    """``run_waves()`` (one ``place_waves`` call for all waves) against one
    ``place_wave`` call a wave: bit for bit on the CPU."""
    make_graph, make_fleet = CASES[case]
    durations, out_bytes, src, dst = make_graph()
    packed = tl.pack_graph(durations, out_bytes, src, dst, bandwidth=BW)
    fleet = make_fleet()
    whole = tl.LeveledRun(packed, *fleet, device="cpu")
    whole.run_waves()
    per_wave = tl.LeveledRun(packed, *fleet, device="cpu")
    per_wave.run_waves(tl.place_wave)
    for field in ("assign", "choices", "load", "spans"):
        assert torch.equal(getattr(whole, field), getattr(per_wave, field)), field


@pytest.mark.parametrize("name", sorted(PACK_GRAPHS))
def test_wave_offsets_table_equals_packed_offsets(name):
    packed = tl.pack_graph(*PACK_GRAPHS[name]())
    run = tl.LeveledRun(packed, *_fleet(4), device="cpu")
    assert run.wave_offsets.dtype == torch.int32
    assert run.wave_offsets.shape == (packed.n_levels + 1,)
    np.testing.assert_array_equal(run.wave_offsets.numpy(), packed.offsets)


def test_place_waves_runs_a_range():
    """Waves [0, k) then [k, L) equal all waves at once."""
    packed = tl.pack_graph(*_random(2000, 6))
    split = tl.LeveledRun(packed, *_mixed_fleet(8, 2), device="cpu")
    k = packed.n_levels // 2
    tl.place_waves(split, 0, k)
    tl.place_waves(split, k, packed.n_levels)
    whole = tl.LeveledRun(packed, *_mixed_fleet(8, 2), device="cpu")
    whole.run_waves()
    assert torch.equal(split.assign, whole.assign)
    assert torch.equal(split.load, whole.load)


def test_place_waves_cuda_raises_on_cpu_tensors():
    packed = tl.pack_graph(*_chain(8))
    run = tl.LeveledRun(packed, *_fleet(2), device="cpu")
    before = tl.place_waves_cuda.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        tl.place_waves_cuda(run, 0, packed.n_levels)
    assert tl.place_waves_cuda.launches == before
