"""The port's hand-written CUDA kernels against their plain versions.

Needs an NVIDIA GPU and nvcc; every test here is marked ``cuda`` and
skips elsewhere.  The file imports no JAX, so on a machine with the card
and no JAX it runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from distributed_tpu_torch import graphs
from distributed_tpu_torch.ops import flash, leveled

pytestmark = pytest.mark.cuda

def o_close(o, want, dtype, pv_term=0.0):
    """flash.O_TOL per element, plus ``pv_term`` where P is rounded."""
    assert o.dtype == want.dtype == dtype
    return flash.o_excess(o, want, pv_term) <= 0.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _pv_term(q, k, v, causal, scale, lse):
    u = flash.P_ROUNDOFF.get(q.dtype, 0.0)
    return u * flash.pv_rounding_term(q, k, v, causal, scale, lse) if u else 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("dim", [64, 128])
@pytest.mark.parametrize("n,nk", [(100, 100), (256, 512), (192, 64), (1024, 1024)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_matches_plain(cuda, dtype, dim, n, nk, causal):
    """bf16/f16 run the tensor-core body (P rounded once before P.V), f32
    the CUDA-core body; each within flash.O_TOL (+ u (P|V|)/l)."""
    g = torch.Generator(device=cuda).manual_seed(n * 7 + dim)
    q, k, v = (torch.randn(3, s, dim, generator=g, device=cuda).to(dtype)
               for s in (n, nk, nk))
    before = flash.flash_forward_cuda.launches
    o, lse = flash.flash_forward(q, k, v, causal, dim ** -0.5)
    torch.cuda.synchronize()
    assert flash.flash_forward_cuda.launches == before + 1
    o_p, lse_p = flash.flash_forward_reference(q, k, v, causal, dim ** -0.5)
    assert o.dtype == dtype and lse.shape == (3, n, 1)
    assert o_close(o, o_p, dtype, _pv_term(q, k, v, causal, dim ** -0.5, lse_p))
    assert (lse - lse_p).abs().max().item() <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("dim", [64, 128])
def test_flash_check_rejects_dropped_keys(cuda, dtype, dim):
    """The O check must reject a kernel that leaves 64 keys out of P.V
    (kept in l and lse), while passing the kernel itself."""
    n, scale = 512, dim ** -0.5
    g = torch.Generator(device=cuda).manual_seed(dim)
    q, k, v = (torch.randn(2, n, dim, generator=g, device=cuda).to(dtype) for _ in range(3))
    o, _ = flash.flash_forward_cuda(q, k, v, True, scale)
    o_p, lse_p = flash.flash_forward_reference(q, k, v, True, scale)
    pv = _pv_term(q, k, v, True, scale, lse_p)
    assert flash.o_excess(o, o_p, pv) <= 0.0
    lo, hi = n // 2, n // 2 + 64
    s = (q.float() * scale) @ k[:, lo:hi].float().transpose(1, 2)
    s = s.masked_fill(torch.arange(n, device=cuda)[:, None]
                      < torch.arange(lo, hi, device=cuda)[None, :], float("-inf"))
    fault = (o_p.float() - torch.exp(s - lse_p) @ v[:, lo:hi].float()).to(dtype)
    assert flash.o_excess(fault, o_p, pv) > 0.0


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16], ids=str)
@pytest.mark.parametrize("dim", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_ragged_heads_stay_apart(cuda, dtype, dim, causal):
    """H=3, N=100: every tile is ragged.  Each head's O and lse must equal
    that head run alone, so no tile reads or writes another head's rows."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn(3, 100, dim, generator=g, device=cuda).to(dtype) for _ in range(3))
    o, lse = flash.flash_forward_cuda(q, k, v, causal, 0.1)
    for h in range(3):
        qh, kh, vh = (x[h:h + 1].contiguous() for x in (q, k, v))
        o_h, lse_h = flash.flash_forward_cuda(qh, kh, vh, causal, 0.1)
        torch.testing.assert_close(o[h:h + 1], o_h, rtol=0, atol=0)
        torch.testing.assert_close(lse[h:h + 1], lse_h, rtol=0, atol=0)


def test_flash_attention_entry_runs_kernel(cuda):
    q = torch.randn(256, 4, 64, device=cuda, dtype=torch.bfloat16)
    before = flash.flash_forward_cuda.launches
    out = flash.flash_attention(q, q, q, causal=True)
    assert flash.flash_forward_cuda.launches == before + 1
    qt = q.transpose(0, 1).contiguous()
    want, lse = flash.flash_forward_reference(qt, qt, qt, True, 0.125)
    assert o_close(out.transpose(0, 1), want, torch.bfloat16,
                   _pv_term(qt, qt, qt, True, 0.125, lse))


def _fleet(W, mixed):
    running = np.ones(W, bool)
    occ = np.zeros(W, np.float32)
    if mixed:
        running[:8] = False
        occ = np.random.default_rng(1).uniform(0, 5, W).astype(np.float32)
    return np.full(W, 2, np.int32), occ, running


@pytest.mark.parametrize("W", [37, 512, 4096, 8192])
@pytest.mark.parametrize("mixed", [False, True])
def test_wave_kernel_matches_plain(cuda, W, mixed):
    """One launch for the whole graph: it sums per worker in task order,
    as index_add_ does on the CPU, so it must reproduce the plain version
    there bit for bit, equal the one-wave-a-launch entry, and repeat."""
    durations, out_bytes, src, dst = graphs.random_dag(50000, seed=3)
    packed = leveled.pack_graph(durations, out_bytes, src, dst)
    fleet = _fleet(W, mixed)
    before = leveled.place_waves_cuda.launches
    got = leveled.place_graph_leveled(packed, *fleet, device=cuda)
    assert leveled.place_waves_cuda.launches == before + 1  # one launch, all waves
    leveled.validate_leveled(packed, got, src, dst, fleet[2])
    want = leveled.place_graph_leveled(packed, *fleet, device="cpu")
    run = leveled.LeveledRun(packed, *fleet, device=cuda)
    run.run_waves(leveled.place_wave_cuda)
    per_wave = run.download()
    run.reset()
    run.run_waves()
    again = run.download()
    for other in (want, per_wave, again):
        for field in ("assignment", "choice", "occupancy", "start_time"):
            np.testing.assert_array_equal(getattr(got, field), getattr(other, field))


def test_wave_kernel_timeline(cuda):
    """``stamps`` records the device clock at each wave's start and after
    each of its 8 barriers, in order, and leaves the placement alone."""
    packed = leveled.pack_graph(*graphs.random_dag(20000, seed=4))
    fleet = _fleet(64, True)
    run = leveled.LeveledRun(packed, *fleet, device=cuda)
    L = packed.n_levels
    stamps = torch.zeros(L * leveled.WAVE_STAMPS, dtype=torch.int64, device=cuda)
    leveled.place_waves_cuda(run, 0, L, stamps=stamps)
    got = run.download()
    assert (stamps.diff() >= 0).all() and (stamps > 0).all()
    want = leveled.place_graph_leveled(packed, *fleet, device="cpu")
    np.testing.assert_array_equal(got.assignment, want.assignment)


def test_wave_kernel_sums_in_task_order(cuda):
    """One wide wave whose tasks all land on few workers, with durations
    whose sum depends on the order of the adds."""
    n = 6149  # several bucketing chunks of a 132-block grid
    rng = np.random.default_rng(0)
    durations = (rng.uniform(0, 1, n) * 10.0 ** rng.integers(-3, 4, n)).astype(np.float32)
    out_bytes = np.zeros(n, np.float32)
    packed = leveled.pack_graph(durations, out_bytes, np.zeros(0, np.int32),
                                np.zeros(0, np.int32))
    fleet = _fleet(3, False)
    got = leveled.place_graph_leveled(packed, *fleet, device=cuda)
    want = leveled.place_graph_leveled(packed, *fleet, device="cpu")
    np.testing.assert_array_equal(got.occupancy, want.occupancy)
    np.testing.assert_array_equal(got.assignment, want.assignment)


def test_wave_kernel_rejects_too_many_workers(cuda):
    packed = leveled.pack_graph(*graphs.random_dag(100, seed=0))
    W = leveled.MAX_WORKERS_CUDA + 1
    with pytest.raises(ValueError, match="at most"):
        leveled.place_graph_leveled(packed, *_fleet(W, False), device=cuda)


@pytest.mark.parametrize("W", [37, 512, 4096])
@pytest.mark.parametrize("mixed", [False, True])
def test_packed_wave_kernel_matches_plain(cuda, W, mixed):
    """The packed wire (11 B/task): the kernel decodes the codes through
    the same table as the plain version, so it must equal the plain
    version on the CPU bit for bit."""
    durations, out_bytes, src, dst = graphs.random_dag(50000, seed=5)
    packed = leveled.pack_graph(durations, out_bytes, src, dst)
    fleet = _fleet(W, mixed)
    results = []
    for device in (cuda, "cpu"):
        run = leveled.LeveledRun(packed, *fleet, device=device, fmt="packed")
        run.run_waves()
        results.append(run.download())
    got, want = results
    leveled.validate_leveled(packed, got, src, dst, fleet[2])
    for field in ("assignment", "choice", "occupancy", "start_time"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


@pytest.mark.parametrize("mixed", [False, True])
def test_streamed_exact_equals_oneshot_on_card(cuda, mixed):
    """compact=False: chunked pinned uploads on a side stream, a launch per
    chunk, segmented downloads; bit for bit the one-shot driver."""
    graph = graphs.random_dag(60000, seed=6)
    fleet = _fleet(64, mixed)
    before = leveled.place_waves_cuda.launches
    tm = {}
    packed, got = leveled.place_graph_streamed(
        *graph, *fleet, compact=False, chunk_rows=8000, min_stream=1, timings=tm,
        device=cuda)
    assert tm["fmt"] == "f16" and tm["launches"] >= 2
    assert leveled.place_waves_cuda.launches == before + tm["launches"]
    want = leveled.place_graph_leveled(leveled.pack_graph(*graph), *fleet, device=cuda)
    for field in ("assignment", "choice", "occupancy", "start_time"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


def test_streamed_reuses_pinned_buffers(cuda):
    """Two packed streamed runs: the second reuses the first's pinned
    staging and download buffers and equals it, and both equal the same
    driver on the CPU (the plain wave on the packed wire)."""
    graph = graphs.random_dag(60000, seed=7)
    fleet = _fleet(64, True)
    kw = dict(compact=True, chunk_rows=7000, min_stream=1)
    _, first = leveled.place_graph_streamed(*graph, *fleet, device=cuda, **kw)
    pinned = leveled.PINNED.allocated
    tm = {}
    _, second = leveled.place_graph_streamed(*graph, *fleet, device=cuda, timings=tm, **kw)
    assert tm["fmt"] == "packed"
    assert leveled.PINNED.allocated == pinned
    _, cpu = leveled.place_graph_streamed(*graph, *fleet, device="cpu", **kw)
    for want in (first, cpu):
        for field in ("assignment", "choice", "occupancy", "start_time"):
            np.testing.assert_array_equal(getattr(second, field), getattr(want, field))
