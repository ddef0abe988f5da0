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

    monkeypatch.setattr("distributed_tpu_torch.scheduler.rebalance.plan_moves", fail)
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
    two), 4,096 workers (a round ranks some thousands of candidates: 4
    merge levels before the last step), sizes with many ties, and a plan whose rounds end early
    (512 rounds on a fleet that settles in far fewer)."""
    return [("two_workers", pc.rebalance_skewed(np.random.default_rng(2), 300, 2), None),
            ("w1000", pc.rebalance_skewed(np.random.default_rng(1000), 20_000, 1000), None),
            ("w4096", pc.rebalance_skewed(np.random.default_rng(4096), 50_000, 4096), None),
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


def _compact(mk, md, mem):
    """:func:`port.compact_rounds` of dense numpy rows, as numpy."""
    out = port.compact_rounds(torch.from_numpy(mk), torch.from_numpy(md), torch.from_numpy(mem))
    return tuple(t.numpy() for t in out)


def k9_lists(owner, nbytes, eligible, W, index_order=False):
    """K9's lists as its wrapper builds them (:func:`port.owner_lists` on
    CPU tensors), as numpy: ``(list, size, off)``, worker w's keys
    ``list[off[w]:off[w + 1]]`` and their sizes.  ``index_order`` plants a
    fault: each list in key order instead of largest first."""
    lst, size, off = port.owner_lists(torch.from_numpy(owner), torch.from_numpy(nbytes),
                                      torch.from_numpy(eligible), W)
    lst, off = lst.numpy().astype(np.int64), off.numpy().astype(np.int64)
    if index_order:
        for w in range(W):
            lst[off[w]:off[w + 1]].sort()
        return lst, nbytes[lst], off
    return lst, size.numpy(), off


PAD = np.uint64(0xFFFFFFFF00000000)  # the kernel's kPad


def k9_codes(key, idx, ties_by_last=False):
    """The kernel's u64 codes: ``key``'s order bits (-0 as +0) above the
    worker's index.  ``ties_by_last`` plants a fault: the index's bits
    reversed, so equal keys rank the higher worker first."""
    u = (key.astype(np.float32) + np.float32(0)).view(np.uint32).astype(np.uint64)
    u = np.where(u & np.uint64(0x80000000), ~u & np.uint64(0xFFFFFFFF), u | np.uint64(0x80000000))
    i = idx.astype(np.uint64)
    if ties_by_last:
        i = np.uint64(0xFFFFFFFF) - i
    return (u << np.uint64(32)) | i


def k9_worker(codes, ties_by_last=False):
    """The workers of :func:`k9_codes`' codes."""
    i = codes & np.uint64(0xFFFFFFFF)
    return (np.uint64(0xFFFFFFFF) - i if ties_by_last else i).astype(np.int64)


def warp_sort(v):
    """The kernel's ``warp_sort``: 32 codes through the bitonic network,
    lane l exchanging with lane l ^ j at each stage."""
    lane = np.arange(32)
    for k in (2, 4, 8, 16, 32):
        j = k // 2
        while j:
            o = v[lane ^ j]
            keep_min = ((lane & j) == 0) == ((lane & k) == 0)
            v = np.where(keep_min, np.minimum(v, o), np.maximum(v, o))
            j //= 2
    return v


FINAL_RUNS = 8  # the kernel's kFinalRuns


def k9_levels(wide):
    """The merge levels a round runs when the wider kind's padded region
    holds ``wide`` codes: until it has at most ``FINAL_RUNS`` runs."""
    levels = 0
    while -(-wide // (32 << levels)) > FINAL_RUNS:
        levels += 1
    return levels


def _below(src, start, n, L, c):
    """The kernel's ``below`` for every code at once: how many of the
    sorted ``src[start:start + n]`` lie below ``c``, by binary lifting
    (steps L, L/2, ..., 1, a step taken while the code at it is below);
    ``n <= 0``: none."""
    cnt = np.zeros(len(c), np.int64)
    step = L
    while step:
        m = cnt + step
        at = np.clip(start + m - 1, 0, len(src) - 1)
        cnt = np.where((m <= n) & (src[at] < c), m, cnt)
        step //= 2
    return cnt


def k9_sort(region, levels):
    """A kind's padded region sorted as the kernel sorts it: each run of 32
    by :func:`warp_sort`; then ``levels`` merges, run length L = 32, 64,
    ..., each code's place in the merged pair its place in its run plus
    the count of the other run's codes below it; then the last step at
    L = 32 << levels, each code's place its place in its run plus the
    counts below it in every other run.  Every count by the kernel's
    binary lifting (:func:`_below`)."""
    src = region.copy()
    P = len(src)
    for r in range(0, P, 32):
        src[r:r + 32] = warp_sort(src[r:r + 32])
    q = np.arange(P)
    for level in range(levels):
        L = 32 << level
        run = q // L
        other = (run ^ 1) * L
        cnt = _below(src, other, np.clip(P - other, 0, L), L, src)
        p = np.where(other < P, (run & ~1) * L + (q - run * L) + cnt, q)
        dst = np.empty_like(src)
        dst[p] = src
        src = dst
    L = 32 << levels
    run = q // L
    p = q - run * L
    for j in range(-(-P // L)):
        n = np.where(run == j, 0, min(L, P - j * L))
        p = p + _below(src, j * L, n, L, src)
    dst = np.empty_like(src)
    dst[p] = src
    return dst


def replay_k9(owner, nbytes, eligible, mem, mean, rounds, **faults):
    """K9's rule in numpy, in its compact form ``(moves, counts, total,
    mem)``: the lists of :func:`k9_lists`, a head pointer and a head size a
    worker; each round the candidates compacted in an order of their own
    (a seeded shuffle: the kernel's atomics take warps in any order),
    senders at the front of the buffer and recipients at its back, each
    kind padded to 32 with distinct pad codes and sorted by :func:`k9_sort`
    (the same number of merge levels for both kinds, as the kernel runs
    them); slot i pairs the i-th of each; the guard and the two updates in
    f32, as the kernel's __fadd_rn / __fsub_rn; the round's live slots
    written out in slot order after the moves before them; the run stops
    after a round that moves nothing, the later rounds counted 0.
    ``faults``: ``index_order`` (see :func:`k9_lists`), ``ties_by_last``
    (see :func:`k9_codes`), ``no_early_stop_fill`` (the counts after the
    stop left as the round before the stop counted), ``pads_below_candidates``
    (the runs padded with code 0, below every candidate),
    ``moves_out_of_slot_order`` (a round's moves written last slot first)."""
    W = len(mem)
    f32 = np.float32
    hi, lo = (f32(x) for x in port.band(mean))
    lst, size, off = k9_lists(owner, nbytes, eligible, W, index_order=faults.get("index_order", False))
    head, end = off[:W].copy(), off[1:]
    hsz = np.where(head < end, size[np.minimum(head, len(size) - 1)], f32(0)).astype(f32)
    mem = (mem.astype(f32) - f32(0)) + f32(0)
    moves, counts = [], np.zeros(rounds, np.int32)
    shuffle = np.random.default_rng(W)
    low_pads = faults.get("pads_below_candidates", False)

    def region(codes, P, at_back):
        out = np.zeros(P, np.uint64) if low_pads else PAD | np.arange(P, dtype=np.uint64)
        if at_back:
            out[P - len(codes):] = codes
        else:
            out[:len(codes)] = codes
        return out

    for k in range(rounds):
        S = np.flatnonzero((mem > hi) & (head < end))
        R = np.flatnonzero(mem < lo)
        S, R = shuffle.permutation(S), shuffle.permutation(R)
        ns, nr = len(S), len(R)
        n = min(ns, nr)
        ps, pr = -(-ns // 32) * 32, -(-nr // 32) * 32
        levels = k9_levels(max(ps, pr))
        ties = faults.get("ties_by_last", False)
        sorted_s = k9_sort(region(k9_codes(-mem[S], S, ties), ps, False), levels)
        sorted_r = k9_sort(region(k9_codes(mem[R], R, ties), pr, True), levels)
        sslot, rslot = (k9_worker(c[:n], ties) for c in (sorted_s, sorted_r))
        live = []
        for i in range(n):
            s, r = sslot[i], rslot[i]
            if f32(mem[r] + hsz[s]) <= hi:
                d = f32(f32(0) + hsz[s])
                mem[s] = f32(f32(mem[s] - d) + f32(0))
                mem[r] = f32(f32(mem[r] - f32(0)) + d)
                h = head[s]
                head[s] = h + 1
                if h + 1 < end[s]:
                    hsz[s] = size[h + 1]
                live.append((lst[h], r))
        if faults.get("moves_out_of_slot_order"):
            live.reverse()
        moves += live
        counts[k] = len(live)
        if not live:
            if faults.get("no_early_stop_fill") and k + 1 < rounds:
                counts[k + 1:] = counts[k - 1] if k else 0
            break
    moves = np.asarray(moves, np.int32).reshape(-1, 2)
    return moves, counts, np.asarray([len(moves)], np.int32), mem


@pytest.mark.parametrize("name,batch,rounds", _premise_cases(),
                         ids=[n for n, *_ in _premise_cases()])
def test_lists_give_the_plain_versions_key_for_every_live_slot(name, batch, rounds):
    """The premise of K9: a sender's largest remaining candidate is the
    head of its list, and moving it is the only thing that changes the
    list, so one pointer a worker, advanced on each move, reads the plain
    version's ``key_of[sender]`` for every live slot of every round; each
    list holds its worker's eligible keys in the stable size order, with
    their sizes."""
    (mk, md, _), (owner, nbytes, eligible, *_) = _plain(batch, rounds)
    owner, nbytes, eligible = owner.numpy(), nbytes.numpy(), eligible.numpy()
    W = len(batch.mem)
    lst, size, off = k9_lists(owner, nbytes, eligible, W)
    np.testing.assert_array_equal(size, nbytes[lst])
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
    version's moves (through :func:`port.compact_rounds`), per-round
    counts, total and memories bit for bit."""
    want, args = _plain(batch, rounds)
    owner, nbytes, eligible, mem, mean = args
    got = replay_k9(owner.numpy(), nbytes.numpy(), eligible.numpy(), mem.numpy(), mean,
                    want[0].shape[0])
    for g, w in zip(got, _compact(*want)):
        np.testing.assert_array_equal(g, w)
    assert got[2][0] > 0


def test_k9_sort_is_the_stable_order_at_every_width():
    """:func:`k9_sort` of a region with ``n`` candidates' codes (many keys
    equal) and its pads puts the candidates first in the stable order of
    (key, worker), from 1 candidate to past 2,048 (4 merge levels before
    the last step), the candidates at the front or at the back of the
    region, at the levels its own width takes and at the one or two more
    that a wider other kind takes."""
    rng = np.random.default_rng(11)
    for n in (1, 2, 31, 32, 33, 64, 100, 383, 1000, 2049, 4090):
        idx = rng.permutation(8192)[:n]
        key = rng.integers(0, 20, n).astype(np.float32) * np.float32(1e5)
        P = -(-n // 32) * 32
        for at_back, extra in ((False, 0), (True, 0), (False, 1), (True, 2)):
            reg = PAD | np.arange(P, dtype=np.uint64)
            codes = k9_codes(key, idx)
            if at_back:
                reg[P - n:] = codes
            else:
                reg[:n] = codes
            got = k9_worker(k9_sort(reg, k9_levels(P) + extra)[:n])
            np.testing.assert_array_equal(got, idx[np.lexsort((idx, key))], err_msg=f"n={n}")


FAULTS = ["index_order", "ties_by_last", "no_early_stop_fill", "pads_below_candidates",
          "moves_out_of_slot_order"]


@pytest.mark.parametrize("fault", FAULTS)
def test_k9_replay_rejects_planted_faults(fault):
    """Each planted fault changes the replay's result on the case it
    concerns: the lists in key order (no longer largest first), ties
    ranked the other way (equal memories), the counts after an early stop
    not cleared, the runs padded below the candidates (the sort's pads),
    and a round's moves written out of slot order."""
    if fault == "ties_by_last":
        batch, rounds = pc.rebalance_balanced(640, 16), 8
        batch = batch._replace(mem=np.where(np.arange(16) < 4, batch.mem * 2, batch.mem
                                            * np.float32(0.5)).astype(np.float32))
    elif fault in ("index_order", "pads_below_candidates", "moves_out_of_slot_order"):
        batch, rounds = pc.rebalance_case(np.random.default_rng(5), 4000, 16), None
    else:
        batch, rounds = pc.rebalance_case(np.random.default_rng(16), 2000, 16), 512
    want, args = _plain(batch, rounds)
    want = _compact(*want)
    owner, nbytes, eligible, mem, mean = args
    a = (owner.numpy(), nbytes.numpy(), eligible.numpy(), mem.numpy(), mean, len(want[1]))
    clean = replay_k9(*a)
    assert all(np.array_equal(g, w) for g, w in zip(clean, want))
    planted = replay_k9(*a, **{fault: True})
    assert not all(g.shape == w.shape and np.array_equal(g, w) for g, w in zip(planted, want))


def _dense_rows_list(batch, rounds):
    """The move list as ``plan_rebalance`` built it from the plain
    version's dense rows before the compact form: a Python loop over each
    round's live slots."""
    (mk, md, _), _ = _plain(batch, rounds)
    out = []
    for k in range(mk.shape[0]):
        for s in np.nonzero(mk[k] >= 0)[0]:
            key = int(mk[k, s])
            if key < len(batch.nbytes):
                out.append((key, int(batch.owner[key]), int(md[k, s])))
    return out


@pytest.mark.parametrize("name,batch,rounds", _premise_cases(),
                         ids=[n for n, *_ in _premise_cases()])
def test_plan_lists_are_the_dense_rows_lists(name, batch, rounds):
    """``plan_rebalance(device="cpu")`` and ``RebalancePath.plan_device``,
    now built from the compact moves with numpy, return the lists the
    loop over the dense rows returned (the path's on the batch it packs);
    ``rebalance_rounds`` on CPU tensors is the plain version through
    ``compact_rounds``."""
    want = _dense_rows_list(batch, rounds)
    assert want and port.plan_rebalance(batch, rounds=rounds, device="cpu") == want
    args = port.padded_inputs(batch, "cpu")
    R = port.round_count(batch, rounds)
    got = port.rebalance_rounds(*args, R)
    dense = port.rebalance_rounds_reference(*args, R)
    for g, w in zip(got, port.compact_rounds(*dense)):
        assert torch.equal(g, w)
    assert got.moves.shape == (int(got.total[0]), 2) and int(got.counts.sum()) == int(got.total[0])
    # the scheduler's path packs every candidate as eligible, at its rounds
    wss, keys = pc.rebalance_fleet(batch)
    moves = RebalancePath(device="cpu").plan_device(wss, keys, batch.owner.tolist(),
                                                    batch.mem.copy())
    packed = batch._replace(eligible=np.ones(len(keys), bool))
    assert [(ts.key, s.idx, r.idx) for ts, s, r in moves] == _dense_rows_list(packed, None)


@pytest.mark.parametrize("name,batch,rounds", _more_cases(), ids=[n for n, *_ in _more_cases()])
def test_plan_rebalance_equals_reference_on_more_cases(name, batch, rounds):
    """The port's plan against the reference's on two workers, 1,000 and
    4,096 workers, many ties and an early end: the moves exactly equal."""
    got = port.plan_rebalance(batch, rounds=rounds, device="cpu")
    assert got == ref.plan_rebalance(ref.RebalanceBatch(*batch), rounds=rounds) != []


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
    want = port.compact_rounds(*port.rebalance_rounds_reference(*args, R))
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
    plan0 = path_mod.plan_moves

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
                path_mod.plan_moves = spy
                try:
                    res = await asyncio.wait_for(c.rebalance(), 30)
                finally:
                    path_mod.plan_moves = plan0
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
