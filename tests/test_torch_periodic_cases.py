"""Seeded inputs of the scheduler's periodic device programs at the sizes
the scheduler sends them, the sequential replays that hold their plans
to the reference's contracts, and tests that the replays reject planted
faults.

The replays are the port's copies of the reference's tests
(``tests/test_ops_stealing_amm.py``): every steal satisfies the python
criterion when the moves are replayed one by one; every drop takes an
existing, non-excluded, non-last replica from the fullest eligible
holder of its round; every rebalance move leaves a sender that was above
the mean, keeps its recipient inside the 1.05x band, moves a key once,
and the imbalance never grows.  Each raises ``AssertionError`` with the
offending move.  The stand-in state, workers and keys carry the fields
the fleet mirror and the rebalance plans read, so they run without the
scheduler; ``rebalance_plan_python`` is a copy of the reference
scheduler's host rebalance plan.  ``chip_smoke.py`` imports this module
too (on a machine without JAX), so it imports nothing of JAX or of the
reference package.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest

from distributed_tpu_torch.ops.amm import DropBatch, plan_drop_rounds
from distributed_tpu_torch.ops.rebalance import RebalanceBatch, plan_rebalance
from distributed_tpu_torch.ops.stealing import LATENCY, StealBatch, make_key, plan_steals

# the scheduler's bounds on one device balance cycle
# (scheduler/stealing.py: DEVICE_MAX_TASKS, DEVICE_MAX_VICTIMS)
MAX_TASKS = 8192
MAX_VICTIMS = 32


def steal_cycle(rng, n_workers: int, threads: int = 2, n_tasks: int = MAX_TASKS,
                n_victims: int = MAX_VICTIMS) -> StealBatch:
    """One balance cycle as the scheduler builds it: ``n_tasks`` stealable
    tasks on ``n_victims`` busy workers, grouped by victim with keys of
    levels 0-14 ranked in arrival order; half the fleet idle (loads below
    the retirement line), the rest lightly loaded; victims carry their
    tasks' compute."""
    W = n_workers
    idle = np.zeros(W, bool)
    idle[rng.permutation(W)[: W // 2]] = True
    busy = np.flatnonzero(~idle)
    victims = rng.choice(busy, min(n_victims, len(busy)), replace=False)
    victim = np.sort(rng.choice(victims, n_tasks)).astype(np.int32)
    compute = rng.uniform(0.05, 0.5, n_tasks).astype(np.float32)
    cost = (rng.uniform(0.0, 0.05, n_tasks) + LATENCY).astype(np.float32)
    occ = np.where(idle, rng.uniform(0.0, 0.15, W), rng.uniform(0.0, 0.1, W)).astype(np.float32)
    np.add.at(occ, victim, compute)
    level = rng.integers(0, 15, n_tasks)
    return StealBatch(
        task_victim=victim, task_key=make_key(level, np.arange(n_tasks)), task_cost=cost,
        task_compute=compute, occ=occ, nthreads=np.full(W, threads, np.int32), idle=idle,
        running=np.ones(W, bool),
    )


def tied_steal_cycle(rng, n_workers: int, threads: int = 2, n_tasks: int = MAX_TASKS,
                     n_victims: int = MAX_VICTIMS) -> StealBatch:
    """A balance cycle full of ties: every victim at the same load, and
    task i on victim ``i % n_victims`` with a key, compute and cost that
    depend on ``i // n_victims`` only, so runs of ``n_victims`` tasks on
    different victims share one (load, key) and only the task index orders
    them; the load is 1 plus a victim's share of all the compute; half the
    fleet idle."""
    W = n_workers
    idle = np.zeros(W, bool)
    idle[rng.permutation(W)[: W // 2]] = True
    busy = np.flatnonzero(~idle)
    victims = rng.choice(busy, min(n_victims, len(busy)), replace=False)
    rank = np.arange(n_tasks) // len(victims)
    n_ranks = int(rank[-1]) + 1
    compute = rng.uniform(0.05, 0.5, n_ranks).astype(np.float32)[rank]
    cost = (rng.uniform(0.0, 0.05, n_ranks) + LATENCY).astype(np.float32)[rank]
    occ = np.where(idle, rng.uniform(0.0, 0.15, W), rng.uniform(0.0, 0.1, W)).astype(np.float32)
    occ[victims] = np.float32(1.0 + compute.sum() / len(victims))
    level = rng.integers(0, 15, n_ranks)[rank]
    return StealBatch(
        task_victim=victims[np.arange(n_tasks) % len(victims)].astype(np.int32),
        task_key=make_key(level, rank), task_cost=cost, task_compute=compute, occ=occ,
        nthreads=np.full(W, threads, np.int32), idle=idle, running=np.ones(W, bool),
    )


def drop_round(rng, n_keys: int, n_workers: int, min_holders: int = 2,
               max_holders: int = 64, excluded_frac: float = 0.1) -> DropBatch:
    """One AMM round over ``n_keys`` replicated keys: each on
    ``min_holders``-``max_holders`` workers, about ``excluded_frac`` of the
    holders in active use, asking to drop up to all but one replica; the
    projected memory is every worker's held bytes."""
    R, W = n_keys, n_workers
    n_hold = rng.integers(min_holders, max_holders + 1, R)
    holders = np.zeros((R, W), bool)
    for r in range(R):
        holders[r, rng.choice(W, n_hold[r], replace=False)] = True
    excluded = holders & (rng.random((R, W)) < excluded_frac)
    nbytes = rng.lognormal(12.0, 2.0, R).astype(np.float32)
    ndrop = rng.integers(1, n_hold).astype(np.int32)
    mem = (holders * nbytes[:, None].astype(np.float64)).sum(0).astype(np.float32)
    return DropBatch(holders, excluded, nbytes, ndrop, mem)


def rebalance_case(rng, n_keys: int, n_workers: int) -> RebalanceBatch:
    """Single-replica keys with lognormal sizes, a quarter of the workers
    holding half the bytes."""
    W = n_workers
    hoarders = rng.permutation(W)[: W // 4]
    nbytes = rng.lognormal(13.0, 1.5, n_keys).astype(np.float32)
    to_hoarder = rng.random(n_keys) < 0.5
    owner = np.where(to_hoarder, rng.choice(hoarders, n_keys), rng.integers(0, W, n_keys))
    mem = np.zeros(W, np.float64)
    np.add.at(mem, owner, nbytes)
    return RebalanceBatch(owner.astype(np.int32), nbytes, np.ones(n_keys, bool),
                          mem.astype(np.float32))


def rebalance_skewed(rng, n_keys: int, n_workers: int, ties: bool = False) -> RebalanceBatch:
    """Like :func:`rebalance_case` at any width from 2 workers (at least one
    hoarder), with a tenth of the keys not eligible (their bytes still
    count in the memory); ``ties``: sizes rounded to 100 kB, so many keys
    share one."""
    W = n_workers
    hoarders = rng.permutation(W)[: max(W // 4, 1)]
    nbytes = rng.lognormal(13.0, 1.5, n_keys)
    if ties:
        nbytes = np.maximum(np.round(nbytes, -5), 1e5)
    nbytes = nbytes.astype(np.float32)
    to_hoarder = rng.random(n_keys) < 0.5
    owner = np.where(to_hoarder, rng.choice(hoarders, n_keys), rng.integers(0, W, n_keys))
    mem = np.zeros(W, np.float64)
    np.add.at(mem, owner, nbytes)
    return RebalanceBatch(owner.astype(np.int32), nbytes, rng.random(n_keys) >= 0.1,
                          mem.astype(np.float32))


def rebalance_balanced(n_keys: int, n_workers: int) -> RebalanceBatch:
    """Keys of one size spread evenly: every worker at the mean, nothing moves."""
    owner = (np.arange(n_keys) % n_workers).astype(np.int32)
    nbytes = np.full(n_keys, 1e5, np.float32)
    mem = np.zeros(n_workers, np.float32)
    np.add.at(mem, owner, nbytes)
    return RebalanceBatch(owner, nbytes, np.ones(n_keys, bool), mem)


class StandInWorker:
    """The fields of a scheduler ``WorkerState`` that the fleet mirror
    reads."""

    def __init__(self, address: str, nthreads: int):
        self.address = address
        self.nthreads = nthreads
        self.occupancy = 0.0
        self.nbytes = 0
        self.processing: set = set()
        self.status = "running"
        self.idx = -1


class _NoTrace:
    def emit(self, *args, **kwargs) -> None:
        pass


class _NoWall:
    @staticmethod
    def phase(name: str, stim: str = ""):
        return contextlib.nullcontext()


class StandInState:
    """The slice of a scheduler ``SchedulerState`` that the fleet mirror
    reads (``workers``, ``running``, ``idle``, ``trace``, ``wall``), with
    the delta calls the state makes into its mirror."""

    def __init__(self):
        self.workers: dict[str, StandInWorker] = {}
        self.running: set = set()
        self.idle: dict[str, StandInWorker] = {}
        self.trace = _NoTrace()
        self.wall = _NoWall()
        self.mirror = None

    def add_worker(self, address: str, nthreads: int) -> StandInWorker:
        ws = StandInWorker(address, nthreads)
        self.workers[address] = ws
        self.running.add(ws)
        self.idle[address] = ws
        self.mirror.on_add_worker(ws)
        return ws

    def update(self, ws: StandInWorker, rng) -> None:
        """New occupancy, bytes, depth and idleness for ``ws``."""
        ws.occupancy = float(rng.uniform(0.0, 4.0))
        ws.nbytes = int(rng.integers(0, 2**30))
        ws.processing = set(range(int(rng.integers(0, 8))))
        if rng.random() < 0.5:
            self.idle[ws.address] = ws
        else:
            self.idle.pop(ws.address, None)
        self.mirror.mark(ws)


class StandInKey:
    """The fields of a scheduler ``TaskState`` that the rebalance plans
    read: a single replica in memory on ``owner``."""

    def __init__(self, key: int, nbytes: float, owner):
        self.key, self.nbytes = key, nbytes
        self.who_has = {owner}
        self.actor = False
        self.state = "memory"

    def get_nbytes(self) -> float:
        return self.nbytes


def rebalance_fleet(batch: RebalanceBatch) -> tuple[list, list]:
    """Stand-in workers (``nbytes`` from ``batch.mem``, ``has_what`` in key
    order) and keys of a rebalance case: ``(wss, keys)``."""
    wss = [StandInWorker(f"tcp://10.4.{w // 256}.{w % 256}:8788", 1)
           for w in range(len(batch.mem))]
    for w, ws in enumerate(wss):
        ws.idx, ws.nbytes, ws.has_what = w, float(batch.mem[w]), {}
    keys = []
    for i, (w, b) in enumerate(zip(batch.owner.tolist(), batch.nbytes.tolist())):
        ts = StandInKey(i, b, wss[w])
        wss[w].has_what[ts] = None
        keys.append(ts)
    return wss, keys


def rebalance_plan_python(wss: list, keyset: set | None) -> list[tuple]:
    """A copy of the reference scheduler's host plan
    (``Scheduler._rebalance_plan_python``, ``scheduler/server.py:1967``),
    the path its gate takes below 512 candidates: the fullest senders shed
    their largest movable keys onto the emptiest recipients, one move at a
    time.  Kept here to time it where the reference cannot be imported."""
    mean = sum(ws.nbytes for ws in wss) / len(wss)
    senders = sorted(
        (ws for ws in wss if ws.nbytes > mean * 1.05),
        key=lambda ws: -ws.nbytes,
    )
    recipients = sorted(
        (ws for ws in wss if ws.nbytes < mean * 0.95),
        key=lambda ws: ws.nbytes,
    )
    moves: list[tuple] = []  # (ts, sender, recipient)
    projected = {ws: ws.nbytes for ws in wss}
    for sender in senders:
        for ts in sorted(sender.has_what, key=lambda t: -t.get_nbytes()):
            if projected[sender] <= mean:
                break
            if keyset is not None and ts.key not in keyset:
                continue
            if ts.actor or len(ts.who_has) != 1 or ts.state != "memory":
                continue
            if not recipients:
                break
            recipient = recipients[0]
            if projected[recipient] + ts.get_nbytes() > mean:
                recipients.sort(key=lambda ws: projected[ws])
                recipient = recipients[0]
                if projected[recipient] + ts.get_nbytes() > mean * 1.05:
                    continue
            moves.append((ts, sender, recipient))
            projected[sender] -= ts.get_nbytes()
            projected[recipient] += ts.get_nbytes()
            recipients.sort(key=lambda ws: projected[ws])
    return moves


def check_steals(batch: StealBatch, thief_of: np.ndarray, tol: float = 1e-4) -> int:
    """Replay the steals one by one: each satisfies the reference criterion
    at its application point (up to ``tol``: the rounds evaluate it at the
    round's loads), no thief is its victim, no task moves twice.  Returns
    the number of steals."""
    occ = np.asarray(batch.occ, np.float64).copy()
    threads = np.maximum(np.asarray(batch.nthreads), 1)
    stolen = np.flatnonzero(thief_of >= 0)
    for t in stolen:
        v, th = int(batch.task_victim[t]), int(thief_of[t])
        assert v != th, f"task {t}: thief {th} is its victim"
        cp, tc = float(batch.task_compute[t]), float(batch.task_cost[t])
        assert occ[th] / threads[th] + tc + cp <= occ[v] / threads[v] - cp / 2 + tol, (
            f"task {t} from {v} to {th} fails the criterion on replay")
        occ[v] -= cp
        occ[th] += cp + tc
    assert len(set(stolen.tolist())) == len(stolen)
    return len(stolen)


def check_drops(batch: DropBatch, rounds: list[list[tuple[int, int]]]) -> int:
    """Replay the drops round by round: each drops an existing replica
    that is not excluded and not the last, no more than asked, one a task
    a round, from the fullest eligible holder at the round's start (up to
    f32 rounding); every satisfiable drop is planned.  Returns the number
    of drops."""
    h = np.asarray(batch.holders).copy()
    exc = np.asarray(batch.excluded)
    nbytes = np.asarray(batch.nbytes)
    m = np.asarray(batch.mem, np.float64).copy()
    left = np.asarray(batch.ndrop).copy()
    planned = np.zeros(len(nbytes), int)
    for rnd in rounds:
        m0 = m.copy()
        seen = set()
        for r, w in rnd:
            assert r not in seen, f"two drops for task {r} in a round"
            seen.add(r)
            assert h[r, w], f"task {r}: dropped a replica {w} that does not exist"
            assert not exc[r, w], f"task {r}: dropped from excluded holder {w}"
            assert h[r].sum() >= 2, f"task {r}: dropped the last replica"
            assert left[r] > 0, f"task {r}: dropped more than requested"
            elig = h[r] & ~exc[r]
            top = m0[elig].max()
            assert m0[w] >= top - max(1e-5 * top, 1e-3), f"task {r}: {w} is not the fullest holder"
            h[r, w] = False
            left[r] -= 1
            planned[r] += 1
            m[w] = max(m[w] - nbytes[r], 0.0)
    holders = np.asarray(batch.holders)
    satisfiable = np.maximum(0, np.minimum.reduce([
        np.asarray(batch.ndrop), (holders & ~exc).sum(1), holders.sum(1) - 1]))
    bad = np.flatnonzero(planned != satisfiable)
    assert not len(bad), f"tasks {bad[:5].tolist()}: planned {planned[bad[:5]].tolist()}, " \
                         f"satisfiable {satisfiable[bad[:5]].tolist()}"
    return int(planned.sum())


def check_rebalance(batch: RebalanceBatch, moves: list[tuple[int, int, int]]) -> tuple[float, float]:
    """Replay the moves: each moves an eligible key once from its owner,
    which was above the mean, to a recipient that stays within 1.05x of
    it; the imbalance does not grow.  Returns the imbalance (max - min)
    before and after."""
    mem = np.asarray(batch.mem, np.float32)
    proj = mem.copy()
    mean = mem.sum() / len(mem)
    seen = set()
    for key, src, dst in moves:
        assert key not in seen, f"key {key} moved twice"
        seen.add(key)
        assert batch.eligible[key] and batch.owner[key] == src, f"key {key}: not {src}'s to move"
        assert proj[src] > mean, f"key {key}: sender {src} was not above the mean"
        assert proj[dst] + batch.nbytes[key] <= mean * 1.05 + 1, (
            f"key {key}: recipient {dst} pushed past the 1.05 band")
        proj[src] -= batch.nbytes[key]
        proj[dst] += batch.nbytes[key]
    before, after = float(mem.max() - mem.min()), float(proj.max() - proj.min())
    assert after <= before, f"imbalance grew: {before} -> {after}"
    return before, after


# ------------------------------------------- the replays against planted faults


def test_cases_are_seeded():
    for make, args in ((steal_cycle, (16,)), (drop_round, (40, 8, 2, 8)), (rebalance_case, (300, 8))):
        a, b = make(np.random.default_rng(3), *args), make(np.random.default_rng(3), *args)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_check_steals_rejects_planted_steals():
    batch = steal_cycle(np.random.default_rng(1), 32, n_tasks=512, n_victims=4)
    thief_of = plan_steals(batch, device="cpu")
    assert check_steals(batch, thief_of) > 0
    t = int(np.flatnonzero(thief_of >= 0)[0])
    onto_victim = thief_of.copy()
    onto_victim[t] = batch.task_victim[t]
    with pytest.raises(AssertionError, match="is its victim"):
        check_steals(batch, onto_victim)
    # every task of the busiest victim onto the idlest thief: the loads cross
    v = int(np.bincount(batch.task_victim).argmax())
    piled = np.full_like(thief_of, -1)
    piled[batch.task_victim == v] = int(np.flatnonzero(batch.idle)[np.argmin(batch.occ[batch.idle])])
    with pytest.raises(AssertionError, match="fails the criterion"):
        check_steals(batch, piled)


def test_check_drops_rejects_planted_drops():
    batch = drop_round(np.random.default_rng(2), 200, 16, max_holders=8)
    rounds = plan_drop_rounds(batch, device="cpu")
    assert check_drops(batch, rounds) > 0
    r, w = np.argwhere(batch.excluded)[0]
    with pytest.raises(AssertionError, match="excluded holder"):
        check_drops(batch, [[(int(r), int(w))]] + rounds)
    with pytest.raises(AssertionError, match="satisfiable"):
        check_drops(batch, [rounds[0][1:]] + rounds[1:])


def test_check_rebalance_rejects_planted_moves():
    batch = rebalance_case(np.random.default_rng(4), 2000, 16)
    moves = plan_rebalance(batch, device="cpu")
    before, after = check_rebalance(batch, moves)
    assert after < before
    with pytest.raises(AssertionError, match="moved twice"):
        check_rebalance(batch, moves + moves[:1])
    key, src, dst = moves[0]
    with pytest.raises(AssertionError, match="not"):
        check_rebalance(batch, [(key, dst, src)])


def test_rebalance_fleet_mirrors_the_batch():
    batch = rebalance_case(np.random.default_rng(5), 500, 8)
    wss, keys = rebalance_fleet(batch)
    assert [ws.nbytes for ws in wss] == batch.mem.tolist()
    assert all(ts.who_has == {wss[w]} for ts, w in zip(keys, batch.owner.tolist()))
    assert sum(len(ws.has_what) for ws in wss) == len(keys)
