"""Work stealing's device path in the port (``distributed_tpu_torch/ops/
stealing.py``, ``scheduler/stealing.py``) against the reference, on the CPU.

- ``steal_rounds_reference`` against the reference's jitted
  ``_steal_rounds`` on the reference's ``random_steal_batch`` (seeds 0-9
  at 200 tasks x 16 workers and 8,192 x 512) and on the scheduler-sized
  cycles of ``test_torch_periodic_cases.steal_cycle``: ``thief_of`` and the final
  occupancy **exactly equal** (the port sums ``others_cp`` in XLA's window
  order, ``partition.xla_row_sum``).
- ``plan_steals`` on the reference's own unit cases, exactly equal, and
  the **re-validation contract** (every steal satisfies the python
  criterion on a sequential replay, ``test_torch_periodic_cases.check_steals``).
- A python replay of K7's group sum (``csrc/steal.cu::victim_sum``: a
  victim's candidates in slot order, added in XLA's windows, zeros
  skipped) against ``xla_row_sum``, exactly equal.
- The reference's sans-io steal scenarios (``tests/test_mirror.py``) with
  the port installed on ``device="cpu"``: the same in-flight moves as the
  reference's device path, ``launches`` > 0, ``failures`` == 0, the python
  scan not run; a planted failure is counted and raised, not absorbed.
- One live ``LocalCluster`` with the port's paths installed and its gate
  lowered by its own parameters.
"""

from __future__ import annotations

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tpu import config
from distributed_tpu.ops import stealing as ref
from distributed_tpu.ops.leveled import _bucket
from distributed_tpu.scheduler.jax_placement import device_dispatch_worthwhile as ref_gate
from distributed_tpu_torch.ops import partition as tpart
import test_torch_periodic_cases as pc
from distributed_tpu_torch.ops import stealing as port
from distributed_tpu_torch.scheduler import gate
from distributed_tpu_torch.scheduler.mirror import TorchMirror
from distributed_tpu_torch.scheduler.periodic import install_periodic
from distributed_tpu_torch.scheduler.stealing import install_stealing

from conftest import gen_test
from test_mirror import _flip_status, _steal_state
from test_ops_stealing_amm import _slow, random_steal_batch

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)


def _padded(batch):
    """The reference's plan_steals padding, as numpy arrays."""
    T = len(batch.task_victim)
    Tp = _bucket(T, floor=64)

    def pad(a, fill, dtype):
        buf = np.full(Tp, fill, dtype)
        buf[:T] = a
        return buf

    return (pad(batch.task_victim, 0, np.int32), pad(batch.task_key, 2**31 - 1, np.int32),
            pad(batch.task_cost, 0, np.float32), pad(batch.task_compute, 0, np.float32),
            np.asarray(batch.occ, np.float32), np.asarray(batch.nthreads, np.int32),
            np.asarray(batch.idle, bool), np.asarray(batch.running, bool))


def _both(batch, rounds=8):
    args = _padded(batch)
    th_r, occ_r = ref._steal_rounds(*map(jnp.asarray, args), K=rounds)
    th_p, occ_p = port.steal_rounds_reference(*map(torch.from_numpy, args), rounds)
    return (np.asarray(th_r), np.asarray(occ_r)), (th_p.numpy(), occ_p.numpy())


@pytest.mark.parametrize("T,W", [(200, 16), (8192, 512)])
@pytest.mark.parametrize("seed", range(10))
def test_steal_rounds_equal_reference(T, W, seed):
    (th_r, occ_r), (th_p, occ_p) = _both(random_steal_batch(np.random.default_rng(seed), T=T, W=W))
    np.testing.assert_array_equal(th_p, th_r)
    np.testing.assert_array_equal(occ_p, occ_r)


@pytest.mark.parametrize("W,T", [(64, 1024), (130, 2000), (512, 4096)])
def test_steal_rounds_equal_reference_on_scheduler_cycles(W, T):
    """Cycles shaped as the scheduler builds them: many steals a round from
    few victims, so the same-victim sums of long runs decide them."""
    batch = pc.steal_cycle(np.random.default_rng(W), W, n_tasks=T)
    (th_r, occ_r), (th_p, occ_p) = _both(batch)
    assert (th_p >= 0).sum() > W // 8
    np.testing.assert_array_equal(th_p, th_r)
    np.testing.assert_array_equal(occ_p, occ_r)
    assert pc.check_steals(batch, th_p[: len(batch.task_victim)]) > 0


@pytest.mark.parametrize("n", [1, 7, 32, 33, 64, 100, 512, 1000, 1024, 1057])
def test_xla_row_sum_equals_jit_row_sum(n):
    x = np.random.default_rng(n).uniform(0, 1, (3, n)).astype(np.float32)
    x[:, ::3] = 0.0
    import jax

    want = np.asarray(jax.jit(lambda a: a.sum(axis=1))(jnp.asarray(x)))
    np.testing.assert_array_equal(tpart.xla_row_sum(torch.from_numpy(x)).numpy(), want)


def _victim_sum(slots, values, W):
    """K7's group sum (csrc/steal.cu::victim_sum) in python: the members'
    values at their ascending slots, added in XLA's windows of 32 level by
    level, the zeros between them skipped."""
    f32 = np.float32
    pads, n = [], W
    while n > 32:
        pad = -n % 32
        pads.append(pad // 2)
        n = (n + pad) // 32
    L = len(pads)
    acc, cur, total = [f32(0)] * L, [-1] * L, f32(0)
    for s, x in zip(slots, values):
        idx = [s]
        for l in range(L):
            idx.append((idx[l] + pads[l]) // 32)
        for l in range(L):
            if cur[l] < 0 or cur[l] == idx[l + 1]:
                break
            if l + 1 < L:
                acc[l + 1] = f32(acc[l + 1] + acc[l])
            else:
                total = f32(total + acc[l])
            acc[l], cur[l] = f32(0), -1
        if L == 0:
            total = f32(total + x)
        else:
            acc[0] = f32(acc[0] + x)
        for l in range(L):
            cur[l] = idx[l + 1]
    for l in range(L):
        if cur[l] >= 0:
            if l + 1 < L:
                acc[l + 1] = f32(acc[l + 1] + acc[l])
            else:
                total = f32(total + acc[l])
    return total


@pytest.mark.parametrize("W", [16, 33, 100, 512, 1000, 1024, 4097])
def test_kernel_group_sum_equals_the_plain_row_sum(W):
    """Each victim's slots, scattered over the row as a round's slots are,
    summed K7's way, equal the plain version's masked row sum bit for
    bit; adding the members front to back does not, at these widths."""
    rng = np.random.default_rng(W)
    victim = rng.integers(0, max(W // 20, 2), W)
    cp = rng.uniform(0.05, 0.5, W).astype(np.float32)
    plain = tpart.xla_row_sum(torch.from_numpy(
        (victim[None, :] == victim[:, None]) * cp[None, :]).float()).numpy()
    naive_differs = False
    for v in np.unique(victim):
        slots = np.flatnonzero(victim == v)
        got = _victim_sum(slots, cp[slots], W)
        assert got == plain[slots[0]], (v, got, plain[slots[0]])
        seq = np.float32(0)
        for x in cp[slots]:
            seq = np.float32(seq + x)
        naive_differs |= seq != got
    assert naive_differs or W <= 64


def _sort_codes(x):
    """K7's order-preserving u32 code of f32 values (csrc/steal.cu::sort_code):
    -0 as +0, NaN after +inf."""
    x = np.asarray(x, np.float32) + np.float32(0)
    u = x.view(np.uint32)
    code = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    return np.where(np.isnan(x), np.uint32(0xFFFFFFFF), code).astype(np.uint64)


def _composites(primary, key):
    return (_sort_codes(primary) << np.uint64(32)) | np.asarray(key, np.int32).view(np.uint32)


def _select_then_sort(comp, nc):
    """K7's task order (csrc/steal.cu::select_tasks) in numpy: a radix
    select of the nc-th smallest composite, most significant byte first
    over the entries still in the running, stopping once a digit holds
    exactly the entries still needed; the entries under the prefix, then
    the first of those equal to it by task index; sorted by (composite,
    index).  Returns the tasks and the passes taken."""
    if nc == 0:
        return np.zeros(0, np.int64), 0
    prefix, shift, need, passes = 0, 64, nc, 0
    while shift > 0:
        first = shift == 64
        shift -= 8
        passes += 1
        live = comp if first else comp[(comp >> np.uint64(shift + 8)) == np.uint64(prefix)]
        hist = np.bincount(((live >> np.uint64(shift)) & np.uint64(255)).astype(np.int64),
                           minlength=256)
        cum = np.cumsum(hist)
        d = int(np.argmax(cum >= need))
        prefix = (prefix << 8) | d
        need -= int(cum[d] - hist[d])
        if hist[d] == need:
            break
    top = comp >> np.uint64(shift)
    below = np.flatnonzero(top < np.uint64(prefix))
    equal = np.flatnonzero(top == np.uint64(prefix))[:need]
    assert len(below) == nc - need
    sel = np.concatenate([below, equal])
    return sel[np.lexsort((sel, comp[sel]))], passes


def _round_state(batch, rounds_done):
    """(primary, key, usable) of the round after ``rounds_done`` rounds of
    the plain version: stolen tasks and padding carry IMAX and sort last."""
    args = [torch.from_numpy(a) for a in _padded(batch)]
    thief_of, occ = port.steal_rounds_reference(*args, rounds_done)
    key = torch.where(thief_of >= 0, port.IMAX, args[1]).numpy()
    vload = (occ / args[5].clamp_min(1).float()).numpy()
    usable = key != port.IMAX
    primary = np.where(usable, -vload[args[0].numpy()], np.float32(np.inf)).astype(np.float32)
    return primary, key, usable


def _full_order(primary, key):
    """The plain version's task order: jnp.lexsort((key, primary)) as two
    stable sorts."""
    by_key = torch.argsort(torch.from_numpy(key), stable=True)
    return by_key[torch.argsort(torch.from_numpy(primary)[by_key], stable=True)].numpy()


def _select_cases():
    rng = np.random.default_rng
    out = {}
    for W, T in ((512, 8192), (1000, 8192), (130, 2000)):
        out[f"cycle{W}x{T}"] = pc.steal_cycle(rng(W + T), W, n_tasks=T)
    for W, T in ((300, 1500), (512, 8192), (64, 64)):
        out[f"tied{W}x{T}"] = pc.tied_steal_cycle(rng(W + T + 1), W, n_tasks=T)
    return out


@pytest.mark.parametrize("rounds_done", [0, 3])
@pytest.mark.parametrize("name", list(_select_cases()))
def test_select_then_sort_gives_the_first_entries_of_the_full_order(name, rounds_done):
    """K7's threshold select, then its sort of the selected, equals the
    first nc entries of the plain version's full stable order on scheduler
    cycles and tie-heavy ones (runs of equal composites across the cut),
    after rounds that stole tasks, for nc from 0 to the usable count and
    each count a round can reach (the idle running thieves, W)."""
    batch = _select_cases()[name]
    primary, key, usable = _round_state(batch, rounds_done)
    comp, order = _composites(primary, key), _full_order(primary, key)
    W, n_us = len(batch.occ), int(usable.sum())
    n_th = int((batch.idle & batch.running).sum())
    for nc in sorted({0, 1, 31, 32, 33, n_th, min(n_th, n_us, W), W, n_us} - {-1}):
        if nc > len(comp):
            continue
        got, passes = _select_then_sort(comp, nc)
        np.testing.assert_array_equal(got, order[:nc], err_msg=f"nc {nc}")
        assert passes <= 8


@pytest.mark.parametrize("nc", [0, 1, 100, 1023, 1024])
def test_select_then_sort_when_all_composites_are_equal(nc):
    """One composite for every task: eight passes, then the first nc tasks
    by index."""
    comp = _composites(np.full(1024, -1.5, np.float32), np.full(1024, 7, np.int32))
    got, passes = _select_then_sort(comp, nc)
    np.testing.assert_array_equal(got, np.arange(nc))
    assert passes == (8 if 0 < nc < 1024 else int(nc > 0))


def test_select_then_sort_with_a_nan_primary_and_signed_zeros():
    """A victim whose load is NaN sorts after the unusable tasks (IMAX
    keys, +inf primaries), and -0 and +0 loads tie: the selection still
    equals the full order, unusable entries in it included, as the slots
    read them (cand_ok then rejects them)."""
    batch = pc.steal_cycle(np.random.default_rng(9), 64, n_tasks=500, n_victims=4)
    occ = batch.occ.copy()
    victims = np.unique(batch.task_victim)
    occ[victims[0]] = np.nan
    occ[victims[1]] = -0.0
    occ[victims[2]] = 0.0
    primary, key, usable = _round_state(batch._replace(occ=occ), 0)
    comp, order = _composites(primary, key), _full_order(primary, key)
    n_us = int(usable.sum())
    assert np.isnan(primary).sum() > 0 and len(comp) > n_us
    for nc in (1, 64, n_us - 1, n_us, len(comp)):
        got, _ = _select_then_sort(comp, nc)
        np.testing.assert_array_equal(got, order[:nc], err_msg=f"nc {nc}")
    assert not usable[order[:n_us]].all()  # the NaN victim's tasks come after the padding


@pytest.mark.parametrize("W,T", [(300, 1500), (512, 8192), (64, 64)])
def test_steal_rounds_equal_reference_on_tied_cycles(W, T):
    """The plain version against the reference on the tie-heavy cycles the
    card tests give K7: the same thieves and occupancy, steals that replay."""
    batch = pc.tied_steal_cycle(np.random.default_rng(W + T + 1), W, n_tasks=T)
    (th_r, occ_r), (th_p, occ_p) = _both(batch)
    np.testing.assert_array_equal(th_p, th_r)
    np.testing.assert_array_equal(occ_p, occ_r)
    assert pc.check_steals(batch, th_p[:T]) > 0


def test_plan_steals_equals_reference_on_its_unit_cases():
    """The reference's own cases (tests/test_ops_stealing_amm.py): low
    levels first, nothing when balanced, an empty batch."""
    W, T = 4, 8
    level = np.asarray([9, 1, 5, 1, 14, 0, 7, 3])
    low = port.StealBatch(np.zeros(T, np.int32), port.make_key(level, np.arange(T)),
                          np.full(T, port.LATENCY, np.float32), np.full(T, 1.0, np.float32),
                          np.asarray([8.0, 0, 0, 0], np.float32), np.ones(W, np.int32),
                          np.asarray([False, True, True, True]), np.ones(W, bool))
    got = port.plan_steals(low, rounds=1, device="cpu")
    np.testing.assert_array_equal(got, ref.plan_steals(ref.StealBatch(*low), rounds=1))
    assert set(np.flatnonzero(got >= 0)) <= {5, 1, 3} and (got >= 0).any()
    rng = np.random.default_rng(1)
    balanced = port.StealBatch(rng.integers(0, 8, 64).astype(np.int32),
                               port.make_key(np.zeros(64, np.int64), np.arange(64)),
                               np.full(64, port.LATENCY, np.float32), np.full(64, 0.1, np.float32),
                               np.full(8, 0.8, np.float32), np.ones(8, np.int32),
                               np.zeros(8, bool), np.ones(8, bool))
    assert (port.plan_steals(balanced, device="cpu") >= 0).sum() == 0
    empty = port.StealBatch(*(np.zeros(0, dt) for dt in (np.int32, np.int32, np.float32, np.float32)),
                            np.zeros(4, np.float32), np.ones(4, np.int32), np.ones(4, bool),
                            np.ones(4, bool))
    assert len(port.plan_steals(empty, device="cpu")) == 0


def test_plan_steals_satisfies_the_python_criterion_sequentially():
    batch = random_steal_batch(np.random.default_rng(0))
    thief_of = port.plan_steals(batch, device="cpu")
    np.testing.assert_array_equal(thief_of, ref.plan_steals(batch))
    assert pc.check_steals(batch, thief_of) > 0


def test_the_double_steal_guard():
    """More idle thieves than stealable tasks: the slots past the last task
    must not clamp onto it and steal it again."""
    W = 16
    batch = port.StealBatch(np.zeros(2, np.int32), port.make_key(np.zeros(2, np.int64), np.arange(2)),
                            np.full(2, port.LATENCY, np.float32), np.full(2, 2.0, np.float32),
                            np.asarray([8.0] + [0.0] * (W - 1), np.float32), np.ones(W, np.int32),
                            np.asarray([False] + [True] * (W - 1)), np.ones(W, bool))
    got = port.plan_steals(batch, rounds=1, device="cpu")
    np.testing.assert_array_equal(got, ref.plan_steals(ref.StealBatch(*batch), rounds=1))
    assert len(set(got[got >= 0].tolist())) == (got >= 0).sum() == 2


def test_idle_victims_equal_reference():
    """Victims that are idle thieves too (random_steal_batch draws victims
    from the whole fleet): a worker is a candidate both ways in one round.
    The criterion then accepts it only one way (a steal needs the thief's
    load below the victim's), and the subtractions from victims land before
    the adds to thieves, as the reference's two scatters do."""
    rng = np.random.default_rng(3)
    W, T = 6, 64
    occ = np.asarray([6.0, 0.05, 4.0, 0.0, 0.08, 0.0], np.float32)
    idle = np.asarray([False, True, True, True, True, True])
    victim = rng.choice([0, 1, 2], T).astype(np.int32)
    batch = port.StealBatch(victim, port.make_key(rng.integers(0, 15, T), np.arange(T)),
                            (rng.uniform(0, 0.05, T) + port.LATENCY).astype(np.float32),
                            rng.uniform(0.05, 0.5, T).astype(np.float32), occ,
                            np.ones(W, np.int32), idle, np.ones(W, bool))
    (th_r, occ_r), (th_p, occ_p) = _both(batch, rounds=4)
    np.testing.assert_array_equal(th_p, th_r)
    np.testing.assert_array_equal(occ_p, occ_r)
    assert (th_p >= 0).sum() > 0


def test_gate_equals_the_reference_gate_under_its_defaults():
    for n_workers in (0, 2, 7, 8, 47, 48, 500):
        for n_items, min_items in ((10, 64), (64, 64), (600, 512)):
            for periodic in (False, True):
                assert gate.device_dispatch_worthwhile(n_workers, n_items, min_items, periodic) \
                    == ref_gate(n_workers, n_items, min_items, periodic)
    assert not gate.device_dispatch_worthwhile(100, 100, 1, True, enabled=False)
    assert gate.device_dispatch_worthwhile(2, 1, 1, True, min_workers=0, periodic_min_workers=0)


# ------------------------------------------------------------ sans-io


def _idle(state):
    return [ws for ws in state.idle.values() if ws in state.running]


@pytest.mark.parametrize("dep_on_thief", [True, False])
def test_sans_io_steal_equals_reference_device_path(dep_on_thief):
    """tests/test_mirror.py's two comm-cost scenarios: the port's device
    path moves what the reference's does, on the TorchMirror, with no
    python pack."""
    state, _, ext, _, w1 = _steal_state(dep_on_thief=dep_on_thief)
    path = install_stealing(ext, device="cpu")
    assert isinstance(state.mirror, TorchMirror)
    ext._balance_device(_idle(state))
    r_state, _, r_ext, _, _ = _steal_state(dep_on_thief=dep_on_thief)
    r_ext._balance_device(_idle(r_state))
    got = sorted((k, i.thief.name) for k, i in ext.in_flight.items())
    assert got == sorted((k, i.thief.name) for k, i in r_ext.in_flight.items())
    assert bool(got) == dep_on_thief
    assert path.launches == 1 and path.failures == 0
    assert state.mirror.oracle_packs == 0


def test_sans_io_overlay_stays_out_of_the_cached_view():
    """A second cycle with moves in flight: the in-flight occupancy is added
    to the kernel's copy (``index_add``, out of place), so the cached
    device occupancy still equals the host rows; the plan equals the
    reference's second cycle."""
    runs = []
    for port_side in (True, False):
        state, _, ext, _, _ = _steal_state(dep_on_thief=True)
        if port_side:
            install_stealing(ext, device="cpu")
        ext._balance_device(_idle(state))
        assert ext.in_flight_occupancy
        ext._balance_device(_idle(state))
        runs.append(sorted((k, i.thief.name) for k, i in ext.in_flight.items()))
        if port_side:
            view = state.mirror.device_view()
            assert torch.equal(view["occupancy"], torch.from_numpy(state.mirror.occupancy))
    assert runs[0] == runs[1]


def test_sans_io_steal_drains_a_paused_victim():
    state, _, ext, w0, w1 = _steal_state(dep_on_thief=True)
    path = install_stealing(ext, device="cpu")
    _flip_status(state, w0, "paused")
    state.saturated.discard(w0)
    state.mirror.mark(w0)
    ext._balance_device(_idle(state))
    assert {i.thief for i in ext.in_flight.values()} == {w1}
    assert path.launches == 1


@pytest.mark.parametrize("use_mirror", [True, False])
def test_sans_io_balance_runs_the_device_path_only(use_mirror, monkeypatch):
    """``balance()`` past the lowered gate: one device cycle, the plan on
    the port's op, and the python scan never entered; without a mirror
    the from-scratch pack feeds the same plan."""
    state, _, ext, _, w1 = _steal_state(dep_on_thief=True)
    if not use_mirror:
        state.mirror = None
    path = install_stealing(ext, device="cpu", min_workers=0, periodic_min_workers=0)
    ext.DEVICE_MIN_TASKS = 1
    monkeypatch.setattr(ext, "_get_thief", lambda *a: pytest.fail("python scan ran"))
    ext.balance()
    assert path.counters() == {"launches": 1, "failures": 0, "cycles_device": 1, "cycles_host": 0}
    assert {i.thief for i in ext.in_flight.values()} == {w1}


def test_sans_io_gate_keeps_small_fleets_on_the_host():
    """Below the periodic worker floor the gate routes the cycle to the
    python scan: counted in cycles_host, no plan."""
    state, _, ext, _, w1 = _steal_state(dep_on_thief=True)
    path = install_stealing(ext, device="cpu")
    ext.balance()
    assert path.counters() == {"launches": 0, "failures": 0, "cycles_device": 0, "cycles_host": 1}


def test_planted_failure_propagates_and_is_counted(monkeypatch):
    """The plan raises: balance() raises it, the path counts and keeps it,
    and no python steal runs in its place."""
    state, _, ext, _, _ = _steal_state(dep_on_thief=True)
    path = install_stealing(ext, device="cpu", min_workers=0, periodic_min_workers=0)
    ext.DEVICE_MIN_TASKS = 1
    boom = RuntimeError("planted")

    def fail(*args, **kwargs):
        raise boom

    monkeypatch.setattr(port, "plan_steals", fail)
    monkeypatch.setattr(ext, "_get_thief", lambda *a: pytest.fail("python scan ran"))
    with pytest.raises(RuntimeError, match="planted"):
        ext.balance()
    assert path.failures == 1 and path.errors == [boom]
    assert path.cycles_device == 1 and path.cycles_host == 0
    assert not ext.in_flight


def test_install_stealing_needs_cuda_by_default(monkeypatch):
    state, _, ext, _, _ = _steal_state(dep_on_thief=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        install_stealing(ext)


# ------------------------------------------------------------- live


@gen_test(timeout=120)
async def test_device_stealing_live_with_the_port():
    """tests/test_ops_stealing_amm.py's live steal, with the port's paths
    installed (gate lowered by its own parameters): the imbalance is
    stolen through the port's plan, nothing fails."""
    from distributed_tpu.client.client import Client
    from distributed_tpu.deploy.local import LocalCluster

    with config.set({"scheduler.work-stealing-interval": "50ms"}):
        async with LocalCluster(n_workers=4, threads_per_worker=1) as cluster:
            handle = install_periodic(cluster.scheduler, device="cpu", min_workers=0,
                                      periodic_min_workers=0)
            steal = cluster.scheduler.extensions["stealing"]
            steal.DEVICE_MIN_TASKS = 1
            async with Client(cluster.scheduler_address) as c:
                await c.submit(_slow, -1, delay=0.1).result()
                w0 = cluster.workers[0].address
                futs = c.map(_slow, range(24), delay=0.1, workers=[w0], allow_other_workers=True)
                assert await asyncio.wait_for(c.gather(futs), 60) == list(range(24))
                assert steal.count >= 1, steal.log
                counts = {w.address: len(w.data) for w in cluster.workers}
                assert sum(1 for v in counts.values() if v) >= 2, counts
            assert handle.stealing.launches > 0 and handle.failures == 0
            assert isinstance(cluster.scheduler.state.mirror, TorchMirror)
