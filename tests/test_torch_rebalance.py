"""The scheduler's rebalance move selection in the port
(``distributed_tpu_torch/ops/rebalance.py``, ``scheduler/rebalance.py``)
against the reference, on the CPU.

- ``plan_rebalance`` against the reference's: the moves **exactly equal**.
  The reference's rounds take ``mean = mem.sum() / W`` in XLA's f32 sum
  order and multiply by the f32 reciprocal of W; the port computes the
  same (``mean_of``), so the moves need not fall back to the invariants.
  The reference's host rule for the number of rounds takes the mean
  another way (numpy's pairwise sum, an f64 division); the port copies
  that too, and a test shows the two means differ.
- The invariants (``test_torch_periodic_cases.check_rebalance``: a sender above the
  mean, a recipient within the 1.05x band, a key moved once, the
  imbalance not grown) on the reference's family and on hoarder fleets.
- ``test_torch_periodic_cases.rebalance_plan_python``, the copy of the reference's
  host plan that the card's smoke run times beside the device plan,
  gives the reference's moves (with and without a key set).
- ``_rebalance_plan_device`` installed on a scheduler equals the
  reference's on the same workers and keys; the gate's host cycles are
  counted; a planted failure is counted and raised.
- K9's rule (``csrc/rebalance.cu``), which cannot run here: the
  per-worker lists its wrapper builds (``owner_lists``), read with one
  pointer a worker that advances on each move, give the plain version's key for every live
  slot of every round; and :func:`replay_k9`, the kernel's whole rule (its
  wrapper's lists, then the rounds' ranks by counting and the early stop
  in numpy), equals the plain version bit for bit and rejects planted
  faults.  On CPU tensors ``rebalance_rounds`` is the plain version and
  never reaches the kernel's library.
- ``Client.rebalance()`` on a live ``LocalCluster(device="cpu")`` plans
  through the device path (the gate's worker floor lowered) and enacts
  its moves with more (sender, recipient) pairs than the scheduler's
  connection pool has slots, which hung before the pool handed idle
  comms' slots to waiting callers.
"""

from __future__ import annotations

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tpu.ops import rebalance as ref
from distributed_tpu.scheduler.server import Scheduler
from distributed_tpu_torch.ops import rebalance as port
from distributed_tpu_torch.scheduler.rebalance import RebalancePath, install_rebalance

import test_torch_periodic_cases as pc
from conftest import gen_test
from test_ops_stealing_amm import _rebalance_setup

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)


def _cases():
    out = [(f"reference{s}", port.RebalanceBatch(*_rebalance_setup(s))) for s in range(4)]
    out += [(f"hoarders{N}x{W}", pc.rebalance_case(np.random.default_rng(N), N, W))
            for N, W in ((2000, 16), (20_000, 64), (30_000, 512))]
    return out


@pytest.mark.parametrize("name,batch", _cases(), ids=[n for n, _ in _cases()])
@pytest.mark.parametrize("rounds", [None, 32])
def test_plan_rebalance_equals_reference(name, batch, rounds):
    got = port.plan_rebalance(batch, rounds=rounds, device="cpu")
    assert got == ref.plan_rebalance(ref.RebalanceBatch(*batch), rounds=rounds)
    assert got
    pc.check_rebalance(batch, got)


@pytest.mark.parametrize("W", [2, 16, 100, 512, 1000])
def test_mean_is_the_reference_rounds_mean(W):
    mem = np.random.default_rng(W).lognormal(15, 2, W).astype(np.float32)
    want = np.float32(jax.jit(lambda m: m.sum() / m.shape[0])(jnp.asarray(mem)))
    assert port.mean_of(mem) == want


def test_reference_means_differ_and_the_port_keeps_both():
    """The reference's two means: its host rule (numpy pairwise f32 sum, f64
    division) and its rounds (XLA's sum order, f32 reciprocal) disagree in
    the last bits on many fleets; the port uses each where the reference
    does."""
    differ = 0
    for seed in range(20):
        mem = np.random.default_rng(seed).lognormal(15, 2, 512).astype(np.float32)
        differ += np.float32(float(mem.sum()) / len(mem)) != port.mean_of(mem)
    assert differ > 0


def test_rebalance_noop_when_balanced():
    W, N = 8, 160
    batch = port.RebalanceBatch(np.repeat(np.arange(W), N // W).astype(np.int32),
                                np.full(N, 1e5, np.float32), np.ones(N, bool),
                                np.full(W, N // W * 1e5, np.float32))
    assert port.plan_rebalance(batch, rounds=8, device="cpu") == []


def test_plan_rebalance_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.plan_rebalance(port.RebalanceBatch(*_rebalance_setup(0)))


# -------------------------------------------------- the scheduler's seam


class _Worker:
    def __init__(self, i, nbytes):
        self.name, self.nbytes, self.has_what = i, nbytes, set()


class _Key:
    def __init__(self, i, nbytes):
        self.key, self.nbytes = i, nbytes

    def get_nbytes(self):
        return self.nbytes


class _SchedulerLike:
    """A bare object carrying the reference's static planners, as a
    ``Scheduler`` instance does."""

    _rebalance_plan_python = staticmethod(Scheduler._rebalance_plan_python)


def test_installed_plan_equals_the_reference_plan():
    owner, nbytes, _, mem = _rebalance_setup(2, N=3000, W=32)
    wss = [_Worker(i, float(m)) for i, m in enumerate(mem)]
    cand = [_Key(i, float(b)) for i, b in enumerate(nbytes)]
    sched = _SchedulerLike()
    path = install_rebalance(sched, device="cpu")
    for given in (None, mem.copy()):
        got = sched._rebalance_plan_device(wss, cand, owner.tolist(), given)
        want = Scheduler._rebalance_plan_device(wss, cand, owner.tolist(), given)
        assert [(ts.key, s.name, r.name) for ts, s, r in got] == \
            [(ts.key, s.name, r.name) for ts, s, r in want] != []
    assert path.counters() == {"launches": 2, "failures": 0, "cycles_device": 2, "cycles_host": 0}
    assert sched._rebalance_plan_python(wss[:2], None) == []
    assert path.cycles_host == 1


def test_planted_failure_is_counted_and_raised(monkeypatch):
    path = RebalancePath(device="cpu")
    boom = RuntimeError("planted")

    def fail(*args, **kwargs):
        raise boom

    monkeypatch.setattr("distributed_tpu_torch.scheduler.rebalance.plan_rebalance", fail)
    with pytest.raises(RuntimeError, match="planted"):
        path.plan_device([_Worker(0, 1.0), _Worker(1, 9.0)], [_Key(0, 1.0)], [1])
    assert path.failures == 1 and path.errors == [boom] and path.launches == 0


@pytest.mark.parametrize("N,W", [(2000, 16), (20_000, 64)])
def test_python_plan_copy_equals_the_reference(N, W):
    batch = pc.rebalance_case(np.random.default_rng(N + W), N, W)
    wss, keys = pc.rebalance_fleet(batch)
    keyset = {ts.key for ts in keys[::3]}
    for ks in (None, keyset):
        got = pc.rebalance_plan_python(wss, ks)
        want = Scheduler._rebalance_plan_python(wss, ks)
        assert [(ts.key, s.idx, r.idx) for ts, s, r in got] == \
            [(ts.key, s.idx, r.idx) for ts, s, r in want] != []


# ------------------------------------------------ K9's rule, where it cannot run


def _more_cases():
    """(name, batch, rounds): two workers, 1,000 workers (not a power of
    two), sizes with many ties, and a plan whose rounds end early (512
    rounds on a fleet that settles in far fewer)."""
    return [("two_workers", pc.rebalance_skewed(np.random.default_rng(2), 300, 2), None),
            ("w1000", pc.rebalance_skewed(np.random.default_rng(1000), 20_000, 1000), None),
            ("ties", pc.rebalance_skewed(np.random.default_rng(7), 5000, 64, ties=True), None),
            ("early_end", pc.rebalance_case(np.random.default_rng(16), 2000, 16), 512)]


def _premise_cases():
    return [(n, b, None) for n, b in _cases()] + _more_cases()


def _plain(batch, rounds):
    """The plain version's rounds on the CPU on the padded inputs, as
    ``plan_rebalance`` runs them, and the padded inputs (numpy)."""
    args = port.padded_inputs(batch, "cpu")
    mk, md, mem = port.rebalance_rounds_reference(*args, port.round_count(batch, rounds))
    return (mk.numpy(), md.numpy(), mem.numpy()), args


def _hi_lo(mean):
    m = torch.tensor(mean, dtype=torch.float32)
    return np.float32((m * 1.05).item()), np.float32((m * 0.95).item())


def k9_lists(owner, nbytes, eligible, W, index_order=False):
    """K9's lists as its wrapper builds them (:func:`port.owner_lists` on
    CPU tensors), as numpy: ``(list, off)``, worker w's keys
    ``list[off[w]:off[w + 1]]``.  ``index_order`` plants a fault: each list
    in key order instead of largest first."""
    lst, off = port.owner_lists(torch.from_numpy(owner), torch.from_numpy(nbytes),
                                torch.from_numpy(eligible), W)
    lst, off = lst.numpy().astype(np.int64), off.numpy().astype(np.int64)
    if index_order:
        for w in range(W):
            lst[off[w]:off[w + 1]].sort()
    return lst, off


def replay_k9(owner, nbytes, eligible, mem, mean, rounds, **faults):
    """K9's rule in numpy: the lists of :func:`k9_lists`, one head pointer
    a worker; each round the candidates ranked by counting those of their
    kind before them by (key, worker), senders by -mem and recipients by
    mem (the kernel compares u64 codes of the two); slot i pairs the i-th of each; the guard and the two updates in
    f32, as the kernel's __fadd_rn / __fsub_rn; the run stops after a
    round that moves nothing.  ``faults``: ``index_order`` (see
    :func:`k9_lists`), ``ties_by_last`` (equal keys ranked by the higher
    worker), ``no_early_stop_fill`` (rows after the stop left as the
    round before wrote them)."""
    W = len(mem)
    f32 = np.float32
    hi, lo = _hi_lo(mean)
    lst, off = k9_lists(owner, nbytes, eligible, W, index_order=faults.get("index_order", False))
    head, end = off[:W].copy(), off[1:]
    mem = (mem.astype(f32) - f32(0)) + f32(0)
    mk = np.full((rounds, W), -1, np.int32)
    md = np.full((rounds, W), -1, np.int32)
    tie = (lambda a, b: a > b) if faults.get("ties_by_last") else (lambda a, b: a < b)

    def ranks(idx, key):
        before = (key[None, :] < key[:, None]) | ((key[None, :] == key[:, None])
                                                  & tie(idx[None, :], idx[:, None]))
        return before.sum(1)

    for k in range(rounds):
        S = np.flatnonzero((mem > hi) & (head < end))
        R = np.flatnonzero(mem < lo)
        n = min(len(S), len(R))
        sslot, rslot = np.empty(len(S), np.int64), np.empty(len(R), np.int64)
        sslot[ranks(S, -mem[S])] = S
        rslot[ranks(R, mem[R])] = R
        moved = False
        for i in range(n):
            s, r = sslot[i], rslot[i]
            key = lst[head[s]]
            size = f32(nbytes[key])
            if f32(mem[r] + size) <= hi:
                d = f32(f32(0) + size)
                mem[s] = f32(f32(mem[s] - d) + f32(0))
                mem[r] = f32(f32(mem[r] - f32(0)) + d)
                head[s] += 1
                mk[k, i], md[k, i] = key, r
                moved = True
        if not moved:
            if faults.get("no_early_stop_fill") and k + 1 < rounds:
                mk[k + 1:] = mk[k - 1] if k else -1
            break
    return mk, md, mem


@pytest.mark.parametrize("name,batch,rounds", _premise_cases(),
                         ids=[n for n, *_ in _premise_cases()])
def test_lists_give_the_plain_versions_key_for_every_live_slot(name, batch, rounds):
    """The premise of K9: a sender's largest remaining candidate is the
    head of its list, and moving it is the only thing that changes the
    list, so one pointer a worker, advanced on each move, reads the plain
    version's ``key_of[sender]`` for every live slot of every round; each
    list holds its worker's eligible keys in the stable size order."""
    (mk, md, _), (owner, nbytes, eligible, *_) = _plain(batch, rounds)
    owner, nbytes, eligible = owner.numpy(), nbytes.numpy(), eligible.numpy()
    W = len(batch.mem)
    lst, off = k9_lists(owner, nbytes, eligible, W)
    order = np.argsort(-nbytes, kind="stable")
    for w in range(W):
        assert np.array_equal(lst[off[w]:off[w + 1]], order[eligible[order] & (owner[order] == w)])
    assert off[W] == eligible.sum()
    ptr = off[:-1].copy()
    live = 0
    for k in range(mk.shape[0]):
        for i in np.flatnonzero(mk[k] >= 0):
            key = mk[k, i]
            s = owner[key]
            assert ptr[s] < off[s + 1] and lst[ptr[s]] == key, (name, k, i)
            ptr[s] += 1
            live += 1
    assert live > 0
    if name == "early_end":
        ran = np.flatnonzero((mk >= 0).any(1))
        assert ran[-1] + 1 < mk.shape[0] // 2


@pytest.mark.parametrize("name,batch,rounds", _premise_cases(),
                         ids=[n for n, *_ in _premise_cases()])
def test_k9_replay_equals_the_plain_version(name, batch, rounds):
    """The kernel's whole rule, replayed in numpy, gives the plain
    version's moves, recipients and memories bit for bit."""
    want, args = _plain(batch, rounds)
    owner, nbytes, eligible, mem, mean = args
    got = replay_k9(owner.numpy(), nbytes.numpy(), eligible.numpy(), mem.numpy(), mean,
                    want[0].shape[0])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fault", ["index_order", "ties_by_last", "no_early_stop_fill"])
def test_k9_replay_rejects_planted_faults(fault):
    """Each planted fault changes the replay's result on the case it
    concerns: the lists in key order (no longer largest first), ties
    ranked the other way (equal memories), and the rows after
    an early stop not filled."""
    if fault == "ties_by_last":
        batch, rounds = pc.rebalance_balanced(640, 16), 8
        batch = batch._replace(mem=np.where(np.arange(16) < 4, batch.mem * 2, batch.mem
                                            * np.float32(0.5)).astype(np.float32))
    elif fault == "index_order":
        batch, rounds = pc.rebalance_case(np.random.default_rng(5), 4000, 16), None
    else:
        batch, rounds = pc.rebalance_case(np.random.default_rng(16), 2000, 16), 512
    want, args = _plain(batch, rounds)
    owner, nbytes, eligible, mem, mean = args
    a = (owner.numpy(), nbytes.numpy(), eligible.numpy(), mem.numpy(), mean, want[0].shape[0])
    clean = replay_k9(*a)
    assert all(np.array_equal(g, w) for g, w in zip(clean, want))
    planted = replay_k9(*a, **{fault: True})
    assert not all(np.array_equal(g, w) for g, w in zip(planted, want))


def test_rebalance_rounds_on_cpu_tensors_is_the_plain_version(monkeypatch):
    """On CPU tensors the dispatch runs the plain version and never loads
    or launches the kernel's library."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path reached the kernel's library")

    monkeypatch.setattr(port._build, "load", refuse)
    monkeypatch.setattr(port._build, "launch", refuse)
    batch = pc.rebalance_case(np.random.default_rng(3), 3000, 32)
    args = port.padded_inputs(batch, "cpu")
    R = port.round_count(batch)
    before = port.rebalance_rounds_cuda.launches
    got = port.rebalance_rounds(*args, R)
    want = port.rebalance_rounds_reference(*args, R)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert port.rebalance_rounds_cuda.launches == before
    assert port.plan_rebalance(batch, device="cpu")
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        port.rebalance_rounds_cuda(*args, R)


# ------------------------------------------------- Client.rebalance() on a cluster


def rebalance_key(i):
    """Seeded bytes, each key its own size."""
    return np.random.default_rng(i).integers(0, 256, 512 + 64 * i, dtype=np.uint8)


async def _slow_echo(x=None):
    await asyncio.sleep(0.01)
    return x


@gen_test(timeout=60)
async def test_pool_hands_idle_slots_to_waiting_callers():
    """Every slot of a pool taken and callers waiting for one: each comm
    handed back idle frees its slot for them (the calls complete)."""
    from distributed_tpu_torch.rpc.core import ConnectionPool, Server

    server = Server({"slow": _slow_echo})
    await server.listen("inproc://")
    pool = ConnectionPool(limit=2)
    try:
        got = await asyncio.wait_for(
            asyncio.gather(*(pool(server.address).slow(x=i) for i in range(6))), 20)
    finally:
        await pool.close()
        await server.close()
    assert got == list(range(6))


@gen_test(timeout=120)
async def test_client_rebalance_plans_on_the_device_path_and_enacts_it():
    """600 keys on 2 of 8 workers: ``Client.rebalance()`` takes the device
    path (on the CPU), its moves are ``plan_rebalance``'s on the batch it
    packed, every move is enacted although the scheduler's pool has 4
    slots for 12 (sender, recipient) pairs, the values stay, and the
    imbalance shrinks."""
    from distributed_tpu_torch import config
    from distributed_tpu_torch.client.client import Client
    from distributed_tpu_torch.deploy.local import LocalCluster
    from distributed_tpu_torch.scheduler import rebalance as path_mod

    batches = []
    plan0 = path_mod.plan_rebalance

    def spy(batch, *args, **kwargs):
        batches.append(batch)
        return plan0(batch, *args, **kwargs)

    with config.set({"scheduler.jax.periodic-min-workers": 0, "scheduler.jax.min-workers": 0}):
        async with LocalCluster(n_workers=8, threads_per_worker=1, device="cpu") as cl:
            async with Client(cl.scheduler_address) as c:
                s = cl.scheduler
                futs = []
                for h in range(2):
                    futs += c.map(rebalance_key, range(h, 600, 2), workers=[cl.workers[h].address])
                before = await c.gather(futs)
                mem0 = [ws.nbytes for ws in s.state.workers.values()]
                s.rpc.limit, s.rpc.semaphore = 4, asyncio.Semaphore(4)
                path_mod.plan_rebalance = spy
                try:
                    res = await asyncio.wait_for(c.rebalance(), 30)
                finally:
                    path_mod.plan_rebalance = plan0
                moves = port.plan_rebalance(batches[0], device="cpu")
                assert len(batches) == 1 and res == {"status": "OK", "moves": len(moves)}
                assert len({(int(batches[0].owner[k]), d) for k, _, d in moves}) > 4
                assert s.rebalance_path.counters() == {"launches": 1, "failures": 0,
                                                       "cycles_device": 1, "cycles_host": 0}
                while any(len(ts.who_has) != 1 for ts in s.state.tasks.values()):
                    await asyncio.sleep(0.01)
                after = await c.gather(futs)
                mem1 = [ws.nbytes for ws in s.state.workers.values()]
    assert all(np.array_equal(a, b) for a, b in zip(after, before))
    assert max(mem1) - min(mem1) < max(mem0) - min(mem0)
