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

import functools
import threading

import numpy as np
import pytest
import torch
import test_torch_periodic_cases as cases

from distributed_tpu_torch import graphs
from distributed_tpu_torch.ops import (
    amm,
    flash,
    ici,
    leveled,
    partition,
    ring_attention,
    sharded,
    stealing,
    ulysses,
)

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)

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


def _on_a_fresh_thread(fn):
    """``fn()`` on a new thread, on which torch has set no device (as on a
    worker's task thread); its exception is raised here."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as exc:  # handed to the caller's thread below
            out["error"] = exc

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    if "error" in out:
        raise out["error"]
    return out["value"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_kernels_launch_from_a_thread_with_no_device_set(cuda, dtype):
    """The library launches in its own CUDA runtime's current context:
    every wrapper makes the tensors' device current first.  Without that,
    K2 failed on such a thread with cudaErrorInvalidValue."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(4, 512, 64, generator=g, device=cuda).to(dtype) for _ in range(3))
    want, _ = flash.flash_forward_cuda(q, k, v, True, 0.125)
    got, _ = _on_a_fresh_thread(lambda: flash.flash_forward_cuda(q, k, v, True, 0.125))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_the_wave_kernel_launches_from_a_thread_with_no_device_set(cuda):
    packed = leveled.pack_graph(*graphs.random_dag(2000, seed=1))
    fleet = (np.full(16, 2, np.int32), np.zeros(16, np.float32), np.ones(16, bool))
    want = leveled.place_graph_leveled(packed, *fleet, device=cuda)
    got = _on_a_fresh_thread(lambda: leveled.place_graph_leveled(packed, *fleet, device=cuda))
    assert np.array_equal(got.assignment, want.assignment)


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


SHARD_LAYOUTS = ["1x1", "2x1", "4x2", "8x1"]


def _shard_mesh(layout, device):
    dt, dw = (int(p) for p in layout.split("x"))
    return partition.make_engine_mesh(layout=layout, devices=[device] * (dt * dw))


def _step_mode(monkeypatch):
    """Every ShardedRun made from here on takes the explicit two-launch
    pair, K10's step mode (what a process group or several devices run)."""
    monkeypatch.setattr(sharded, "ShardedRun", functools.partial(
        sharded.ShardedRun, body=(sharded.shard_tentative, sharded.shard_contend)))


def _k10_launches():
    return sharded.place_shard_run_cuda.launches, sharded.place_shard_cuda.launches


@pytest.mark.parametrize("mode", ["run", "step"])
@pytest.mark.parametrize("layout", SHARD_LAYOUTS)
@pytest.mark.parametrize("W", [37, 512, 1000])
@pytest.mark.parametrize("mixed", [False, True])
def test_shard_kernel_matches_plain(cuda, layout, W, mixed, mode, monkeypatch):
    """K10, every shard of the mesh on the one card: it sums each shard's
    partials per worker in task order, as index_add_ does on the CPU, so it
    reproduces the plain shard body there bit for bit, repeats, and at 1x1
    equals K1.  Run mode (ShardedRun's own rule here) makes one launch a
    fused run; step mode (the explicit pair) two launches a wave.  The
    uniform fleet's wave 0 is all ties (every worker at load 0)."""
    durations, out_bytes, src, dst = graphs.random_dag(60000, seed=8)
    packed = leveled.pack_graph(durations, out_bytes, src, dst)
    fleet = _fleet(W, mixed)
    mesh = _shard_mesh(layout, cuda)
    if mode == "step":
        _step_mode(monkeypatch)
    before = _k10_launches()
    got = sharded.place_graph_leveled_sharded(mesh, packed, *fleet)
    took = tuple(a - b for a, b in zip(_k10_launches(), before))
    runs = len(sharded._plan_runs_sharded(packed.offsets, mesh.size))
    assert took == ((runs, 0) if mode == "run" else (0, 2 * packed.n_levels))
    leveled.validate_leveled(packed, got, src, dst, fleet[2])
    again = sharded.place_graph_leveled_sharded(mesh, packed, *fleet)
    want = sharded.place_graph_leveled_sharded(_shard_mesh(layout, "cpu"), packed, *fleet)
    others = [want, again]
    if layout == "1x1":
        others.append(leveled.place_graph_leveled(packed, *fleet, device=cuda))
    for other in others:
        for field in ("assignment", "choice", "occupancy", "start_time"):
            np.testing.assert_array_equal(getattr(got, field), getattr(other, field))


@pytest.mark.parametrize("layout", SHARD_LAYOUTS)
@pytest.mark.parametrize("mixed", [False, True])
def test_shard_run_mode_equals_step_mode(cuda, layout, mixed, monkeypatch):
    """On 512 workers, uniform and mixed: run mode, twice, and step mode
    are bit-identical to each other and to the plain body on the CPU."""
    durations, out_bytes, src, dst = graphs.random_dag(100_000, seed=13)
    packed = leveled.pack_graph(durations, out_bytes, src, dst)
    fleet = _fleet(512, mixed)
    mesh = _shard_mesh(layout, cuda)
    run = [sharded.place_graph_leveled_sharded(mesh, packed, *fleet) for _ in range(2)]
    plain = sharded.place_graph_leveled_sharded(_shard_mesh(layout, "cpu"), packed, *fleet)
    _step_mode(monkeypatch)
    before = _k10_launches()
    step = sharded.place_graph_leveled_sharded(mesh, packed, *fleet)
    assert _k10_launches()[0] == before[0]
    for other in (run[1], step, plain):
        for field in ("assignment", "choice", "occupancy", "start_time"):
            np.testing.assert_array_equal(getattr(run[0], field), getattr(other, field))


def test_shard_kernel_sums_in_task_order(cuda):
    """One wide wave on few workers over 4 shards, with durations whose
    per-shard sums depend on the order of the adds."""
    n = 24_581
    rng = np.random.default_rng(0)
    durations = (rng.uniform(0, 1, n) * 10.0 ** rng.integers(-3, 4, n)).astype(np.float32)
    packed = leveled.pack_graph(durations, np.zeros(n, np.float32), np.zeros(0, np.int32),
                                np.zeros(0, np.int32))
    fleet = _fleet(3, False)
    got = sharded.place_graph_leveled_sharded(_shard_mesh("4x1", cuda), packed, *fleet)
    want = sharded.place_graph_leveled_sharded(_shard_mesh("4x1", "cpu"), packed, *fleet)
    np.testing.assert_array_equal(got.occupancy, want.occupancy)
    np.testing.assert_array_equal(got.assignment, want.assignment)


def test_shard_kernel_fed_by_the_mirror_view(cuda):
    """K11's blocks on the card (1,000 workers in a capacity of 1,024,
    dw = 2) feed K10 as the host arrays do."""
    from distributed_tpu_torch.scheduler.mirror import TorchMirror

    state = cases.StandInState()
    m = state.mirror = TorchMirror(state, device=cuda)
    for i in range(1000):
        state.add_worker(f"w{i}", 2)
    rng = np.random.default_rng(3)
    for ws in list(state.workers.values())[::7]:
        state.update(ws, rng)
    fv = m.fleet_view()
    assert m.cap == 1024
    fleet = (fv.nthreads.copy(), fv.occupancy.copy(), fv.running.copy())
    packed = leveled.pack_graph(*graphs.random_dag(40000, seed=9))
    mesh = _shard_mesh("2x2", cuda)
    view = m.sharded_device_view(mesh)
    assert all(b.device == cuda for b in view["occupancy"])
    before = _k10_launches()
    got = sharded.place_graph_leveled_sharded(mesh, packed, *fleet, fleet_dev=view)
    runs = len(sharded._plan_runs_sharded(packed.offsets, mesh.size))
    assert tuple(a - b for a, b in zip(_k10_launches(), before)) == (runs, 0)  # run mode
    want = sharded.place_graph_leveled_sharded(_shard_mesh("2x2", "cpu"), packed, *fleet)
    np.testing.assert_array_equal(got.assignment, want.assignment)
    np.testing.assert_array_equal(got.occupancy, want.occupancy)


def test_shard_kernel_rejects_too_many_workers(cuda):
    packed = leveled.pack_graph(*graphs.random_dag(100, seed=0))
    fleet = _fleet(leveled.MAX_WORKERS_CUDA + 1, False)
    with pytest.raises(ValueError, match="at most"):
        sharded.place_graph_leveled_sharded(_shard_mesh("1x1", cuda), packed, *fleet)


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


# ---------------------------------------------------- periodic paths (K6-K8)


def _steal_args(batch, dev):
    """plan_steals' padded tensors for ``batch`` on ``dev``."""
    T = len(batch.task_victim)
    Tp = stealing._bucket(T, floor=64)

    def pad(a, fill, dtype):
        buf = np.full(Tp, fill, dtype)
        buf[:T] = a
        return torch.from_numpy(buf).to(dev)

    return (pad(batch.task_victim, 0, np.int32), pad(batch.task_key, stealing.IMAX, np.int32),
            pad(batch.task_cost, 0, np.float32), pad(batch.task_compute, 0, np.float32),
            *(torch.as_tensor(a).to(dev) for a in (batch.occ, batch.nthreads, batch.idle,
                                                   batch.running)))


@pytest.mark.parametrize("W,T,victims", [(16, 200, 8), (512, 8192, 32), (1000, 8192, 32),
                                         (33, 5000, 33), (4096, 8192, 32), (64, 20_000, 32)])
def test_steal_kernel_matches_plain(cuda, W, T, victims):
    """K7 == the plain version on the CPU bit for bit (thief_of and occ),
    twice, one launch a cycle; the last two cases run on global scratch
    (4,096 workers, 20,000 tasks: past the block's shared memory)."""
    batch = cases.steal_cycle(np.random.default_rng(W + T), W, n_tasks=T,
                                       n_victims=victims)
    want = stealing.steal_rounds_reference(*_steal_args(batch, "cpu"), 8)
    args = _steal_args(batch, cuda)
    before = stealing.steal_rounds_cuda.launches
    got = stealing.steal_rounds_cuda(*args, 8)
    again = stealing.steal_rounds_cuda(*args, 8)
    torch.cuda.synchronize()
    assert stealing.steal_rounds_cuda.launches == before + 2
    for g, a, w in zip(got, again, want):
        assert torch.equal(g.cpu(), w) and torch.equal(a, g)
    n = cases.check_steals(batch, got[0][:T].cpu().numpy())
    assert n > 0


@pytest.mark.parametrize("W", [300, 512, 1000, 4096])
@pytest.mark.parametrize("T", [64, 1500, 8192])
def test_steal_kernel_matches_plain_on_tied_cycles(cuda, W, T):
    """K7 on cycles full of ties (victims at one load, runs of equal keys
    across victims: the select's cut falls inside runs of equal
    composites) == the plain version on the CPU bit for bit, twice; 4,096
    workers run on global scratch."""
    batch = cases.tied_steal_cycle(np.random.default_rng(W + T), W, n_tasks=T)
    want = stealing.steal_rounds_reference(*_steal_args(batch, "cpu"), 8)
    args = _steal_args(batch, cuda)
    got = stealing.steal_rounds_cuda(*args, 8)
    again = stealing.steal_rounds_cuda(*args, 8)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g.cpu(), w) and torch.equal(a, g)
    assert cases.check_steals(batch, got[0][:T].cpu().numpy()) > 0


@pytest.mark.parametrize("W", [512, 1000, 4096])
def test_steal_kernel_timeline(cuda, W):
    """A run with ``stamps`` gives the run without them, and its marks
    rise through every phase of every round."""
    batch = cases.steal_cycle(np.random.default_rng(W), W)
    args = _steal_args(batch, cuda)
    stamps = torch.zeros(1 + 8 * len(stealing.STEAL_PHASES), dtype=torch.int64, device=cuda)
    timed = stealing.steal_rounds_cuda(*args, 8, stamps=stamps)
    plain = stealing.steal_rounds_cuda(*args, 8)
    assert all(torch.equal(a, b) for a, b in zip(timed, plain))
    t = stamps.cpu()
    assert bool((t[1:] >= t[:-1]).all()) and bool((t > 0).all())


def test_steal_kernel_uses_shared_memory_while_it_fits(cuda):
    lib = stealing._build.load()
    assert stealing._layout(lib, 8192, 1024)[1]
    assert not stealing._layout(lib, 8192, 4096)[1]


def test_plan_steals_on_the_card(cuda):
    batch = cases.steal_cycle(np.random.default_rng(5), 300, n_tasks=1500)
    np.testing.assert_array_equal(stealing.plan_steals(batch),
                                  stealing.plan_steals(batch, device="cpu"))


@pytest.mark.parametrize("R,W,blocks", [(64, 12, None), (16_384, 512, None), (16_384, 512, 1),
                                        (3000, 100, 3), (5000, 1000, None), (200, 40_000, None)])
def test_drop_kernel_matches_plain(cuda, R, W, blocks):
    """K8 == the plain version on the CPU bit for bit (drops and memory)
    at any grid, twice, one launch a plan; past 32,767 workers its holder
    lists are int32."""
    batch = cases.drop_round(np.random.default_rng(R + W), R, W, max_holders=min(64, W))
    K = 64
    cpu = [torch.from_numpy(np.asarray(a)) for a in batch]
    want = amm.drop_rounds_reference(*cpu, K)
    dev = [t.to(cuda) for t in cpu]
    before = amm.drop_rounds_cuda.launches
    got = amm.drop_rounds_cuda(*dev, K, blocks=blocks)
    again = amm.drop_rounds_cuda(*dev, K, blocks=blocks)
    torch.cuda.synchronize()
    assert amm.drop_rounds_cuda.launches == before + 2
    for g, a, w in zip(got, again, want):
        assert torch.equal(g.cpu(), w) and torch.equal(a, g)
    rounds = amm.plan_drop_rounds(batch)
    assert cases.check_drops(batch, rounds) > 0


@pytest.mark.parametrize("blocks", [1, 3, None])
def test_drop_kernel_matches_plain_on_rows_held_by_every_worker(cuda, blocks):
    """K8 on rows held by all 500 workers (lists of up to 500 holders, 16
    a lane; some rows wholly excluded) == the plain version on the CPU bit
    for bit at grids of 1, 3 and the default, twice."""
    rng = np.random.default_rng(500)
    R, W = 2000, 500
    holders = np.ones((R, W), bool)
    excluded = rng.random((R, W)) < 0.1
    excluded[:20] = True
    batch = amm.DropBatch(holders, excluded, rng.lognormal(12.0, 2.0, R).astype(np.float32),
                          rng.integers(1, 64, R).astype(np.int32),
                          rng.uniform(0, 1e9, W).astype(np.float32))
    cpu = [torch.from_numpy(np.asarray(a)) for a in batch]
    want = amm.drop_rounds_reference(*cpu, 64)
    dev = [t.to(cuda) for t in cpu]
    got = amm.drop_rounds_cuda(*dev, 64, blocks=blocks)
    again = amm.drop_rounds_cuda(*dev, 64, blocks=blocks)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g.cpu(), w) and torch.equal(a, g)
    assert (got[0] >= 0).sum() > 0


def test_drop_kernel_timeline(cuda):
    """A run with ``stamps`` gives the run without them; its marks rise
    through the prologue and every phase of the rounds that ran, and the
    rounds after the first one that dropped nothing keep their zeros."""
    batch = cases.drop_round(np.random.default_rng(62), 4096, 512)
    dev = [torch.from_numpy(np.asarray(a)).to(cuda) for a in batch]
    K = 64
    stamps = torch.zeros(2 + K * len(amm.DROP_PHASES), dtype=torch.int64, device=cuda)
    timed = amm.drop_rounds_cuda(*dev, K, stamps=stamps)
    plain = amm.drop_rounds_cuda(*dev, K)
    assert all(torch.equal(a, b) for a, b in zip(timed, plain))
    ran = min(K, int((plain[0] >= 0).any(dim=0).sum()) + 1)  # and the round that found nothing
    t = stamps.cpu()
    n = 2 + ran * len(amm.DROP_PHASES)
    assert bool((t[1:n] >= t[: n - 1]).all()) and bool((t[:n] > 0).all())
    assert bool((t[n:] == 0).all())


def test_drop_kernel_keeps_rows_without_an_eligible_holder(cuda):
    """A row whose holders are all excluded: its argmax is worker 0 and it
    drops nothing, on the card as on the CPU."""
    holders = np.zeros((4, 6), bool)
    holders[:, 2:5] = True
    excluded = holders.copy()
    excluded[1, 3] = False
    batch = amm.DropBatch(holders, excluded, np.full(4, 10.0, np.float32),
                          np.full(4, 2, np.int32), np.arange(6, dtype=np.float32))
    assert amm.plan_drops(batch) == amm.plan_drops(batch, device="cpu") == [(1, 3)]


def test_mirror_device_view_row_uploads(cuda):
    """TorchMirror's device view on the card equals the host rows bit for
    bit: one full upload at first use and after growth, nothing on a fresh
    view, exactly the dirty rows otherwise."""
    from distributed_tpu_torch.scheduler.mirror import DEVICE_FIELDS, TorchMirror

    rng = np.random.default_rng(0)
    state = cases.StandInState()
    mirror = state.mirror = TorchMirror(state)
    workers = [state.add_worker(f"w{i}", 2) for i in range(40)]
    for n_dirty in (None, 0, 1, 7, 40, "grow"):
        before = mirror.stats()
        if n_dirty == "grow":
            workers += [state.add_worker(f"g{i}", 1) for i in range(mirror.cap)]
        elif n_dirty:
            for ws in rng.choice(workers, n_dirty, replace=False):
                state.update(ws, rng)
        view = mirror.device_view()
        torch.cuda.synchronize()
        for name in DEVICE_FIELDS:
            assert view[name].device.type == "cuda"
            np.testing.assert_array_equal(view[name].cpu().numpy(), getattr(mirror, name))
        after = mirror.stats()
        full = n_dirty in (None, "grow")
        assert after["full_uploads"] - before["full_uploads"] == full
        assert after["rows_uploaded"] - before["rows_uploaded"] == (0 if full else n_dirty)


# ------------------------------------------------ the shuffle's bucket pass


def _bucket_inputs(cuda, S, n, row, masked, seed, one_dest=False, all_masked=False):
    """S shards of n rows: int32 keys, ``row`` = (shape, dtype) values."""
    shape, dtype = row
    g = torch.Generator(device="cpu").manual_seed(seed)
    keys = torch.randint(-(2 ** 31), 2 ** 31 - 1, (S, n), generator=g, dtype=torch.int64)
    keys = keys.to(torch.int32)
    if one_dest:
        keys[-1] = 7  # the last shard sends every row to one destination
    vals = (torch.randn((S, n, *shape), generator=g) * 100).to(dtype)
    valid = None
    if masked or all_masked:
        valid = torch.rand((S, n), generator=g) < 0.7
        if all_masked:
            valid[0] = False
    put = [x.to(cuda) for x in (keys, vals)]
    return (list(put[0].unbind(0)), list(put[1].unbind(0)),
            None if valid is None else list(valid.to(cuda).unbind(0)))


ROWS = {"4B": ((1,), torch.float32), "8B": ((4,), torch.float16), "20B": ((5,), torch.float32),
        "16B": ((4,), torch.int32)}


@pytest.mark.parametrize("S", [1, 3, 8])
@pytest.mark.parametrize("row", sorted(ROWS))
@pytest.mark.parametrize("case", ["plain", "masked", "one_dest", "all_masked", "truncated"])
def test_shuffle_bucket_kernel_matches_plain(cuda, S, row, case):
    """K12 equals shuffle_bucket_reference bit for bit (keys, value bytes,
    sent, the zero padding), and repeats itself."""
    n, n_dev = 10_000 + S, 8
    keys, vals, valid = _bucket_inputs(cuda, S, n, ROWS[row], case == "masked", S * 31 + n,
                                       one_dest=case == "one_dest",
                                       all_masked=case == "all_masked")
    cap = 200 if case == "truncated" else ici.default_capacity(n, n_dev)
    before = ici.shuffle_bucket_cuda.launches
    got = ici.shuffle_bucket(keys, vals, valid, n_dev, cap)
    again = ici.shuffle_bucket_cuda(keys, vals, valid, n_dev, cap)
    torch.cuda.synchronize()
    assert ici.shuffle_bucket_cuda.launches == before + 8
    for s in range(S):
        want = ici.shuffle_bucket_reference(keys[s], vals[s], None if valid is None else valid[s],
                                            n_dev, cap)
        for w, g1, g2 in zip(want, (got[0][s], got[1][s], got[2][s]),
                             (again[0][s], again[1][s], again[2][s])):
            assert w.dtype == g1.dtype and w.shape == g1.shape
            wb = w.contiguous().view(torch.uint8)
            assert torch.equal(wb, g1.contiguous().view(torch.uint8))
            assert torch.equal(wb, g2.contiguous().view(torch.uint8))
    if case == "all_masked":
        assert int(got[2][0].sum()) == 0 and not got[0][0].any()


@pytest.mark.parametrize("n_dev", [1, 3, 1024])
def test_shuffle_bucket_kernel_destination_counts(cuda, n_dev):
    keys, vals, valid = _bucket_inputs(cuda, 2, 5000, ROWS["4B"], True, n_dev)
    got = ici.shuffle_bucket_cuda(keys, vals, valid, n_dev, 64)
    for s in range(2):
        want = ici.shuffle_bucket_reference(keys[s], vals[s], valid[s], n_dev, 64)
        assert all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                   for a, b in zip(want, (got[0][s], got[1][s], got[2][s])))


def test_shuffle_on_mesh_on_the_card(cuda):
    """8 virtual shards on one card through LocalShards: equal to the CPU run."""
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1 << 30, 8 * 4096).astype(np.int32)
    vals = rng.random((8 * 4096, 4)).astype(np.float32)
    valid = rng.random(8 * 4096) < 0.9
    card = ici.shuffle_on_mesh(ici.make_mesh_1d(8, devices=[cuda] * 8), keys, vals, valid=valid)
    host = ici.shuffle_on_mesh(ici.make_mesh_1d(8, devices=["cpu"] * 8), keys, vals, valid=valid)
    for a, b in zip(card, host):
        for x, y in zip(a, b):
            assert x.device.type == "cuda"
            assert torch.equal(x.cpu().view(torch.uint8), y.view(torch.uint8))


def test_shuffle_bucket_refuses_bad_shapes(cuda):
    keys, vals, _ = _bucket_inputs(cuda, 1, 100, ROWS["4B"], False, 0)
    with pytest.raises(ValueError, match="destinations"):
        ici.shuffle_bucket_cuda(keys, vals, None, ici.MAX_DESTS_CUDA + 1, 16)
    with pytest.raises(ValueError, match="int32"):
        ici.shuffle_bucket_cuda([k.long() for k in keys], vals, None, 8, 16)


# --------------------------------------------------------- long context


def _ring_missing_a_step(q, k, v, n, causal, scale, step=1):
    """A planted fault: the ring's fold of each shard's visible blocks
    (flash_forward, then ``_merge``) with ring step ``step`` left out."""
    qt, kt, vt = (ring_attention._heads_first(x.chunk(n)) for x in (q, k, v))
    out = []
    for d in range(n):
        o = lse = None
        for s in range(n):
            owner = (d - s) % n
            if s != step and ring_attention._visible(d, owner, causal):
                o_b, lse_b = flash.flash_forward(qt[d], kt[owner], vt[owner],
                                                 causal and owner == d, scale)
                o, lse = ring_attention._merge(o, lse, o_b, lse_b)
        out.append(o)
    return out


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_ring_attention_on_the_card(cuda, causal, dtype):
    """The ring with K2 a block against the plain ring, within
    ring_attention.ring_excess; one step left out fails it."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(8 * 256, 4, 64, generator=g, device=cuda).to(dtype) for _ in range(3))
    mesh = ici.make_mesh_1d(8, axis="sp", devices=[cuda] * 8)
    before = flash.flash_forward_cuda.launches
    out = ring_attention.ring_attention(mesh, q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash.flash_forward_cuda.launches - before == (36 if causal else 64)
    plain = ring_attention.ring_attention_reference(mesh, q, k, v, causal=causal)
    terms = ring_attention.ring_rounding_terms(q, k, v, 8, causal, 64 ** -0.5)
    assert max(ring_attention.ring_excess(out[i], plain[i], terms[i]) for i in range(8)) <= 0.0
    bad = _ring_missing_a_step(q, k, v, 8, causal, 64 ** -0.5)
    fault = [ring_attention.ring_excess(bad[i].to(dtype).transpose(0, 1), plain[i], terms[i])
             for i in range(8)]
    assert max(fault) > 0.0


def test_ulysses_on_the_card_equals_k2_on_the_whole_sequence(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn(8 * 256, 16, 128, generator=g, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    mesh = ici.make_mesh_1d(8, axis="sp", devices=[cuda] * 8)
    out = torch.cat(ulysses.ulysses_attention(mesh, q, k, v, causal=True))
    whole = flash.flash_attention(q, k, v, causal=True)
    qt, kt, vt = (x.transpose(0, 1).contiguous() for x in (q, k, v))
    o_p, lse_p = flash.flash_forward_reference(qt, kt, vt, True, 128 ** -0.5)
    pv = flash.P_ROUNDOFF[torch.bfloat16] * flash.pv_rounding_term(qt, kt, vt, True,
                                                                   128 ** -0.5, lse_p)
    assert flash.o_excess(out.transpose(0, 1), o_p, pv) <= 0.0
    assert flash.o_excess(whole.transpose(0, 1), o_p, pv) <= 0.0


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_on_the_card_runs_k2_at_a_ragged_length(cuda, causal):
    """8 x 1000 rows: the gathered 8,000 do not divide by 128, and each
    head group still goes through K2 (one launch a shard), within K2's
    contract against the plain forward on the whole sequence."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn(8 * 1000, 8, 64, generator=g, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    mesh = ici.make_mesh_1d(8, axis="sp", devices=[cuda] * 8)
    before = flash.flash_forward_cuda.launches
    out = torch.cat(ulysses.ulysses_attention(mesh, q, k, v, causal=causal))
    torch.cuda.synchronize()
    assert flash.flash_forward_cuda.launches - before == 8
    qt, kt, vt = (x.transpose(0, 1).contiguous() for x in (q, k, v))
    o_p, lse_p = flash.flash_forward_reference(qt, kt, vt, causal, 64 ** -0.5)
    pv = flash.P_ROUNDOFF[torch.bfloat16] * flash.pv_rounding_term(qt, kt, vt, causal,
                                                                   64 ** -0.5, lse_p)
    assert flash.o_excess(out.transpose(0, 1), o_p, pv) <= 0.0


def test_ulysses_refuses_a_head_dim_k2_cannot_take(cuda):
    q = torch.zeros(8 * 128, 8, 32, device=cuda)
    mesh = ici.make_mesh_1d(8, axis="sp", devices=[cuda] * 8)
    with pytest.raises(ValueError, match="head dim"):
        ulysses.ulysses_attention(mesh, q, q, q)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_ring_attention_backward_on_the_card(cuda, causal, dtype):
    """The ring's backward, K3 a visible block (36 / 64 calls), within
    ring_bwd_excess of autograd through the plain ring; both planted
    faults rejected; two backward calls bit-identical."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q, k, v, do = (torch.randn(8 * 256, 4, 64, generator=g, device=cuda).to(dtype)
                   for _ in range(4))
    mesh = ici.make_mesh_1d(8, axis="sp", devices=[cuda] * 8)
    leaves = tuple(x.clone().requires_grad_() for x in (q, k, v))
    out = ring_attention.ring_attention(mesh, *leaves, causal=causal)
    dos = list(do.chunk(8))
    before = flash.flash_backward_cuda.launches
    grads = torch.autograd.grad(out, leaves, dos, retain_graph=True)
    torch.cuda.synchronize()
    assert flash.flash_backward_cuda.launches - before == (36 if causal else 64)
    again = torch.autograd.grad(out, leaves, dos)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    per_shard = [tuple(x.chunk(8)[i] for x in grads) for i in range(8)]
    plain = ring_attention.ring_backward_reference(mesh, q, k, v, do, causal=causal)
    o = torch.cat([x.detach() for x in out])
    terms = ring_attention.ring_bwd_rounding_terms(q, k, v, o, do, 8, causal, 64 ** -0.5)
    excess = [max(ring_attention.ring_bwd_excess(per_shard[i], plain[i], terms[i]))
              for i in range(8)]
    assert max(excess) <= 0.0, excess
    fault_a, fault_b = ring_attention.ring_bwd_planted_faults(q, k, v, o, do, per_shard, 8, causal,
                                                              64 ** -0.5)
    assert min(max(ring_attention.ring_bwd_excess(fault_a[i], plain[i], terms[i]))
               for i in range(8)) > 0.0
    assert max(ring_attention.ring_bwd_excess(fault_b[4], plain[4], terms[4])) > 0.0


@pytest.mark.parametrize("n_local", [256, 1000])
@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_backward_on_the_card(cuda, n_local, causal):
    """Ulysses' backward: one K3 call a head group (8), the gradients equal
    K3's on K2's residuals of each head group mapped back, each within
    flash.bwd_excess of the plain backward; 8 x 1000 rows is ragged."""
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v, do = (torch.randn(8 * n_local, 16, 128, generator=g, device=cuda).to(torch.bfloat16)
                   for _ in range(4))
    mesh = ici.make_mesh_1d(8, axis="sp", devices=[cuda] * 8)
    leaves = tuple(x.clone().requires_grad_() for x in (q, k, v))
    out = ulysses.ulysses_attention(mesh, *leaves, causal=causal)
    before = flash.flash_backward_cuda.launches
    grads = torch.autograd.grad(out, leaves, list(do.chunk(8)))
    torch.cuda.synchronize()
    assert flash.flash_backward_cuda.launches - before == 8
    local = ici.LocalShards(mesh)
    heads = [[h.transpose(0, 1).contiguous() for h in ulysses.seq_to_heads(local, list(x.chunk(8)), 8)]
             for x in (q, k, v, do)]
    k3 = []
    for qt, kt, vt, dot in zip(*heads):
        o, lse = flash.flash_forward_cuda(qt, kt, vt, causal, 128 ** -0.5)
        res = (qt, kt, vt, o, lse, dot)
        got = flash.flash_backward_cuda(*res, causal, 128 ** -0.5)
        plain = flash.flash_backward_reference(*res, causal, 128 ** -0.5)
        terms = flash.bwd_rounding_terms(*res, causal, 128 ** -0.5)
        assert max(flash.bwd_excess(got, plain, terms)) <= 0.0
        k3.append(got)
    for i, gr in enumerate(grads):
        back = torch.cat(ulysses.heads_to_seq(local, [x[i].transpose(0, 1) for x in k3], 8))
        assert torch.equal(back, gr)


@pytest.mark.parametrize("fleet", ["uniform", "nonuniform"])
def test_the_wavefront_on_the_card_equals_the_cpu_bit_for_bit(cuda, fleet):
    """The wave's loads add each worker's tasks in task order on the card
    too (``segment_sum_in_order``), so the whole placement, start times
    and loads are the CPU run's bit for bit."""
    from distributed_tpu_torch.ops import wavefront

    dur, ob, src, dst = graphs.random_dag(50_000, seed=2)
    occ = (np.zeros(64, np.float32) if fleet == "uniform"
           else np.random.default_rng(1).uniform(0, 5, 64).astype(np.float32))
    running = np.ones(64, bool)
    running[:2] = fleet == "uniform"
    workers = (np.full(64, 2, np.int32), occ, running)
    gd = wavefront.GraphArrays.from_arrays(dur, ob, src.astype(np.int64), dst.astype(np.int64),
                                           device=cuda)
    got = wavefront.place_graph(gd, *workers)
    want = wavefront.place_graph(wavefront.GraphArrays(*(x.cpu() for x in gd)), *workers)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_round1_placers_on_the_card_equal_the_cpu(cuda):
    """decide_workers (both modes), K15 at 4x2 and place_graph on the card
    against the CPU run: assignments exact (the missing bytes add in edge
    order on both), the parallel occupancy within f32 reordering (CUDA
    index_add_), the wavefront wave by wave from the CPU run's state
    within K1's gate (``chip_smoke.wave_lockstep``)."""
    import chip_smoke

    from distributed_tpu_torch.ops import placement, wavefront
    from distributed_tpu_torch.parallel import mesh as pmesh

    w, b = chip_smoke.r1_problem(1024, 64, seed=3)

    def on(device):
        return (placement.WorkerArrays(*w).to(device),
                placement.build_batch_arrays(*b[:4], restrict=b[4], device=device))

    for sequential in (True, False):
        got = placement.decide_workers(*on(cuda), 1e8, sequential=sequential)
        want = placement.decide_workers(*on("cpu"), 1e8, sequential=sequential, device="cpu")
        assert torch.equal(got[0].cpu(), want[0])
        torch.testing.assert_close(got[1].cpu(), want[1], rtol=1e-5, atol=0.0)
    m = pmesh.make_mesh(devices=[cuda] * 8, layout="4x2")
    single = placement.decide_workers(*on(cuda), 1e8, sequential=False)[0]
    assert torch.equal(pmesh.sharded_decide_workers(m, *on(cuda), 1e8), single)
    dur, ob, src, dst = graphs.random_dag(50_000, seed=2)
    fleet = (np.full(64, 2, np.int32), np.zeros(64, np.float32), np.ones(64, bool))
    gd = wavefront.GraphArrays.from_arrays(dur, ob, src.astype(np.int64), dst.astype(np.int64),
                                           device=cuda)
    res = wavefront.place_graph(gd, *fleet)
    wavefront.validate_placement(gd, res, fleet[2])
    want = wavefront.place_graph(wavefront.GraphArrays(*(x.cpu() for x in gd)), *fleet)
    assert int(res.n_waves) == int(want.n_waves)
    least, load_err, _, waves = chip_smoke.wave_lockstep(wavefront, gd, fleet)
    assert waves == int(want.n_waves)
    assert least >= chip_smoke.K1_MIN_AGREEMENT and load_err <= chip_smoke.K1_LOAD_RTOL
