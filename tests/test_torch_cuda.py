"""The port's hand-written CUDA kernels against their plain versions.

Needs an NVIDIA GPU and nvcc; every test here is marked ``cuda`` and
skips elsewhere.  The file imports no JAX, so on a machine with the card
and no JAX it runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The placement extension's live ``LocalCluster`` tests are not here: the
reference's control plane needs ``msgpack`` and ``cloudpickle``, which that
machine does not have, so they run on the CPU (``test_torch_placement.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from distributed_tpu_torch import graphs
from distributed_tpu_torch.ops import flash, leveled, partition

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


# ------------------------------------------------------------------ K3


def _bwd_case(cuda, dtype, dim, n, nk, causal, seed, heads=3):
    """Residuals as the autograd Function saves them (K2's O and lse) and
    a dO, with the plain backward and its rounding terms on them."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (torch.randn(heads, s, dim, generator=g, device=cuda).to(dtype)
               for s in (n, nk, nk))
    do = torch.randn(heads, n, dim, generator=g, device=cuda).to(dtype)
    scale = dim ** -0.5
    o, lse = flash.flash_forward_cuda(q, k, v, causal, scale)
    res = (q, k, v, o, lse, do)
    plain = flash.flash_backward_reference(*res, causal, scale)
    terms = flash.bwd_rounding_terms(*res, causal, scale)
    return res, scale, plain, terms


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("dim", [64, 128])
@pytest.mark.parametrize("n,nk", [(100, 100), (256, 512), (192, 64), (1024, 1024),
                                  (101, 203), (203, 101)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_kernel_matches_plain(cuda, dtype, dim, n, nk, causal):
    """K3 on identical residuals: within flash.BWD_TOL of the plain
    backward (+ u times the rounding terms for bf16/f16), one count a
    call, the same bits from a second call, and both planted faults (a
    q-tile left out of dK/dV, a k-tile out of dQ) rejected.  101 and 203:
    N not a multiple of 4 (the lse rows K3 pads), cross-length both ways
    with neither length a multiple of the tensor-core body's 128-row
    blocks."""
    res, scale, plain, terms = _bwd_case(cuda, dtype, dim, n, nk, causal, seed=n * 7 + dim)
    before = flash.flash_backward_cuda.launches
    got = flash.flash_backward(*res, causal, scale)
    torch.cuda.synchronize()
    assert flash.flash_backward_cuda.launches == before + 1
    assert [g.dtype for g in got] == [dtype] * 3
    assert [g.shape for g in got] == [x.shape for x in res[:3]]
    assert max(flash.bwd_excess(got, plain, terms)) <= 0.0
    again = flash.flash_backward_cuda(*res, causal, scale)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    fault_a, fault_b = flash.bwd_planted_faults(*res, causal, scale, plain)
    assert max(flash.bwd_excess(fault_a, plain, terms)[1:]) > 0.0
    assert flash.bwd_excess(fault_b, plain, terms)[0] > 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("dim", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_ragged_heads_stay_apart(cuda, dtype, dim, causal):
    """H=3, N=100: every tile is ragged.  Each head's gradients must equal
    that head run alone, so no tile reads or writes another head's rows."""
    (q, k, v, o, lse, do), scale, _, _ = _bwd_case(cuda, dtype, dim, 100, 100, causal, seed=5)
    got = flash.flash_backward_cuda(q, k, v, o, lse, do, causal, scale)
    for h in range(3):
        alone = flash.flash_backward_cuda(*(x[h:h + 1].contiguous() for x in (q, k, v, o, lse, do)),
                                          causal, scale)
        for a, b in zip(got, alone):
            torch.testing.assert_close(a[h:h + 1], b, rtol=0, atol=0)


def test_flash_bwd_rejects_other_head_dims(cuda):
    q = torch.randn(2, 64, 32, device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros(2, 64, 1, device=cuda)
    before = flash.flash_backward_cuda.launches
    with pytest.raises(ValueError, match="head dim"):
        flash.flash_backward(q, q, q, q, lse, q, True, 0.2)
    assert flash.flash_backward_cuda.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_backward_runs_both_kernels(cuda, dtype, causal):
    """``flash_attention(...).backward()`` on the card: K2 then K3, once
    each, and the gradients land on the caller's [seq, heads, dim]
    tensors, near the plain forward and backward's."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(256, 4, 64, generator=g, device=cuda).to(dtype).requires_grad_()
               for _ in range(3))
    w = torch.randn(256, 4, 64, generator=g, device=cuda).to(dtype)
    fwd, bwd = flash.flash_forward_cuda.launches, flash.flash_backward_cuda.launches
    (flash.flash_attention(q, k, v, causal=causal) * w).sum().backward()
    assert flash.flash_forward_cuda.launches == fwd + 1
    assert flash.flash_backward_cuda.launches == bwd + 1
    qt, kt, vt = (x.detach().transpose(0, 1).contiguous() for x in (q, k, v))
    o, lse = flash.flash_forward_reference(qt, kt, vt, causal, 0.125)
    want = flash.flash_backward_reference(qt, kt, vt, o, lse, w.transpose(0, 1), causal, 0.125)
    for x, wt in zip((q, k, v), want):
        assert x.grad.dtype == dtype
        err = (x.grad.transpose(0, 1).float() - wt.float()).abs().max().item()
        assert err <= flash.E2E_RTOL[dtype] * wt.float().abs().max().item()


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


# ------------------------------------------------------------------ K4


def _partition_case(T, seed, ties):
    """A random DAG; with ``ties`` every duration is 1 and every weight one
    of two values, so scores and loads tie all over the rows."""
    durations, out_bytes, src, dst = graphs.random_dag(T, seed=seed)
    weights = (out_bytes[src] / 100e6 + 0.001).astype(np.float32)
    if ties:
        durations = np.ones(T, np.float32)
        weights = np.where(np.arange(len(src)) % 3 == 0, 0.5, 1.0).astype(np.float32)
    return durations, weights, src, dst


def _partition_both(case, W, cuda, **kw):
    runs = [partition.PartitionRun(*case, W, device=device, **kw) for device in (cuda, "cpu")]
    before = partition.partition_cuda.launches
    partition.partition_cuda(runs[0])
    launches = partition.partition_cuda.launches - before
    partition.partition_reference(runs[1])
    return runs, launches


@pytest.mark.parametrize("T,W", [(3000, 8), (16384, 1024), (5000, 1008), (1500, 16_384),
                                 (1024, 31_250)])
@pytest.mark.parametrize("ties", [False, True])
def test_partition_kernel_matches_plain(cuda, T, W, ties):
    """K4 adds every score cell and lane load in the reference's order, so
    it must equal the plain version on the CPU bit for bit: on random
    graphs, on graphs full of ties, and on fleets wide enough that the
    score row needs the shared-memory opt-in (16k and 31,250 lanes).  All
    rounds are one launch."""
    (run, cpu), launches = _partition_both(_partition_case(T, T + W, ties), W, cuda)
    assert launches == 1
    np.testing.assert_array_equal(run.result(), cpu.result())
    again = partition.PartitionRun(*_partition_case(T, T + W, ties), W, device=cuda)
    partition.partition_cuda(again)
    np.testing.assert_array_equal(again.result(), cpu.result())


@pytest.mark.parametrize("T,W", [(262_144, 16), (1_000_000, 16), (2_000_000, 8)])
@pytest.mark.parametrize("ties", [False, True])
def test_partition_kernel_few_lanes(cuda, T, W, ties):
    """The few-lane batches the router sends K4 (up to 2^20 tasks on 16
    lanes, 2^21 on 8; the load phase's counting sort): one launch,
    bit-identical to the plain version on the CPU, and again on a repeat
    with the default grid and on grids of 1 and 3 blocks."""
    case = _partition_case(T, T + W, ties)
    (run, cpu), launches = _partition_both(case, W, cuda)
    assert launches == 1
    want = cpu.result()
    np.testing.assert_array_equal(run.result(), want)
    for blocks in (None, 1, 3):
        again = partition.PartitionRun(*case, W, device=cuda)
        before = partition.partition_cuda.launches
        partition.partition_cuda(again, blocks=blocks)
        assert partition.partition_cuda.launches == before + 1
        np.testing.assert_array_equal(again.result(), want)


@pytest.mark.parametrize("W", [3, 40, 1024, 16_384])
def test_partition_kernel_labels_do_not_depend_on_the_grid(cuda, W):
    """Grids of 1, 3 and the default number of blocks, with both load modes
    (the counting sort up to 64 lanes, else a warp a lane) and each rows
    unit (a thread, a warp, a block a task), give the plain version's
    labels."""
    case = _partition_case(6000 if W < 16_384 else 1500, W, False)
    cpu = partition.PartitionRun(*case, W, device="cpu")
    partition.partition_reference(cpu)
    for blocks in (None, 1, 3):
        run = partition.PartitionRun(*case, W, device=cuda)
        partition.partition_cuda(run, blocks=blocks)
        np.testing.assert_array_equal(run.result(), cpu.result())


@pytest.mark.parametrize("W", [16, 1024])
def test_partition_kernel_timeline(cuda, W):
    """With ``stamps`` the kernel notes the device clock at its start and
    after each phase (both load modes), in order, and its labels do not
    change."""
    case = _partition_case(5000, W, False)
    cpu = partition.PartitionRun(*case, W, device="cpu")
    partition.partition_reference(cpu)
    run = partition.PartitionRun(*case, W, device=cuda)
    stamps = torch.zeros(2 * run.iters + 1, dtype=torch.int64, device=cuda)
    partition.partition_cuda(run, stamps=stamps)
    np.testing.assert_array_equal(run.result(), cpu.result())
    t = stamps.cpu()
    assert t[0] > 0 and bool((t[1:] >= t[:-1]).all())


def test_partition_kernel_blockwise_and_given_init(cuda):
    """The tensordot proxy (uniform weights: ties everywhere), from
    block_init and from a random initial labelling, one and eight rounds."""
    _, d, ob, s, t = graphs.blockwise_tensordot(12)
    w = (ob[s] / 100e6 + 0.001).astype(np.float32)
    init = np.random.default_rng(0).integers(0, 40, len(d)).astype(np.int32)
    for kw in ({}, {"init": init}, {"iters": 1}):
        (run, cpu), _ = _partition_both((d, w, s, t), 40, cuda, **kw)
        np.testing.assert_array_equal(run.result(), cpu.result())


def test_partition_padded_on_the_card(cuda):
    case = _partition_case(4000, 9, False)
    np.testing.assert_array_equal(partition.partition_padded(*case, 64),
                                  partition.partition_padded(*case, 64, device="cpu"))


def test_partition_refused_launch_raises(cuda):
    """A score row past the shared memory a block may have (60,000 lanes,
    325 KB with the blocked flags and the load phase's tile), or a grid
    larger than can be resident: the launch is refused and the wrapper
    raises, each time it is asked, and the next launch is not charged with
    that error."""
    case = _partition_case(200, 1, False)
    run = partition.PartitionRun(*case, 60_000, device=cuda)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="dtpu_partition: CUDA error"):
            partition.partition_cuda(run)
    with pytest.raises(RuntimeError, match="dtpu_partition: CUDA error"):
        partition.partition_cuda(partition.PartitionRun(*case, 8, device=cuda), blocks=1_000_000)
    (ok, cpu), _ = _partition_both(case, 8, cuda)
    np.testing.assert_array_equal(ok.result(), cpu.result())


@pytest.mark.parametrize("partitioner", ["auto", "off"])
def test_torch_placement_plans_on_the_card(cuda, partitioner):
    """``TorchPlacement()`` defaults to the card: the partitioner's plan
    through K4 (``auto``) or the leveled engine's through K1 (``off``),
    each the same hints as the extension on the CPU."""
    from distributed_tpu_torch.scheduler.torch_placement import TorchPlacement

    placement = TorchPlacement(sync=True, partitioner=partitioner)
    assert placement.device.type == "cuda"
    durations, out_bytes, src, dst = graphs.random_dag(6000, seed=11)
    fleet = _fleet(64, True)
    args = ([f"k{i}" for i in range(6000)], durations, out_bytes, src, dst, *fleet,
            [f"w{i}" for i in range(64)], 100e6, 0.001)
    k4, k1 = partition.partition_cuda.launches, leveled.place_waves_cuda.launches
    got = placement._plan_from_arrays(*args)
    if partitioner == "auto":
        assert partition.partition_cuda.launches == k4 + 1
    else:
        assert leveled.place_waves_cuda.launches == k1 + 1
    want = TorchPlacement(sync=True, partitioner=partitioner, device="cpu")._plan_from_arrays(*args)
    assert got == want


def test_torch_placement_plans_on_its_planner_thread(cuda):
    """The async plan runs on the extension's daemon thread, which starts
    with no CUDA state of its own: both branches there give the hints the
    calling thread gets."""
    from distributed_tpu_torch.scheduler.torch_placement import TorchPlacement, _DaemonExecutor

    durations, out_bytes, src, dst = graphs.random_dag(5000, seed=12)
    fleet = _fleet(32, False)
    args = ([f"k{i}" for i in range(5000)], durations, out_bytes, src, dst, *fleet,
            [f"w{i}" for i in range(32)], 100e6, 0.001)
    for partitioner in ("auto", "off"):
        placement = TorchPlacement(partitioner=partitioner)
        executor = _DaemonExecutor("torch-placement-test")
        try:
            got = executor.submit(placement._plan_from_arrays, *args).result(timeout=120)
        finally:
            executor.shutdown()
        assert got == placement._plan_from_arrays(*args)
