"""The Active Memory Manager's device path in the port
(``distributed_tpu_torch/ops/amm.py``, ``scheduler/amm.py``) against the
reference, on the CPU.

- ``drop_rounds_reference`` against the reference's jitted
  ``_drop_rounds``: the drops and the final memory **exactly equal**, on
  the reference's own test family and on AMM-sized rounds with up to 64
  holders a key; ``plan_drops`` exactly equal to the reference's.
- The **re-validation contract** (``test_torch_periodic_cases.check_drops``: never
  the last replica, never an excluded holder, the fullest eligible holder
  at each round's start, every satisfiable drop planned).
- A row whose holders are all excluded drops nothing (its argmax is
  worker 0, which is not eligible).
- The reference's sans-io AMM scenario (``tests/test_mirror.py``) with the
  port installed on ``device="cpu"``: the same remove-replicas messages as
  the reference's device round, ``launches`` > 0, ``failures`` == 0, and a
  planted failure counted and raised out of the policy's generator.
- One live ``LocalCluster`` round with the port's paths installed.
"""

from __future__ import annotations

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tpu import config
from distributed_tpu.ops import amm as ref
from distributed_tpu.scheduler.amm import ActiveMemoryManagerExtension, ReduceReplicas
from distributed_tpu.utils.test import StubScheduler
from distributed_tpu_torch.ops import amm as port
import test_torch_periodic_cases as pc
from distributed_tpu_torch.scheduler.amm import install_amm
from distributed_tpu_torch.scheduler.mirror import TorchMirror
from distributed_tpu_torch.scheduler.periodic import install_periodic

from conftest import gen_test
from test_mirror import _state

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)


def _reference_family(seed, R=60, W=12):
    """tests/test_ops_stealing_amm.py's over-replicated state."""
    rng = np.random.default_rng(seed)
    holders = rng.random((R, W)) < 0.4
    holders[:, 0] |= ~holders.any(axis=1)
    excluded = (rng.random((R, W)) < 0.1) & holders
    nbytes = rng.uniform(1e3, 1e6, R).astype(np.float32)
    desired = np.maximum(1, rng.integers(1, 3, R))
    ndrop = np.maximum(holders.sum(1) - desired, 0).astype(np.int32)
    mem = (holders * nbytes[:, None]).sum(0).astype(np.float32)
    return port.DropBatch(holders, excluded, nbytes, ndrop, mem)


def _cases():
    out = [(f"reference{s}", _reference_family(s)) for s in range(4)]
    out += [("reference_wide", _reference_family(7, R=2000, W=64))]
    out += [(f"amm{R}x{W}", pc.drop_round(np.random.default_rng(R), R, W, max_holders=min(64, W)))
            for R, W in ((300, 8), (1000, 64), (2048, 130))]
    return out


@pytest.mark.parametrize("name,batch", _cases(), ids=[n for n, _ in _cases()])
def test_drop_rounds_equal_reference(name, batch):
    K = 64
    d_r, m_r = ref._drop_rounds(*map(jnp.asarray, batch), K=K)
    d_p, m_p = port.drop_rounds_reference(*(torch.from_numpy(np.asarray(a)) for a in batch), K)
    np.testing.assert_array_equal(d_p.numpy(), np.asarray(d_r))
    np.testing.assert_array_equal(m_p.numpy(), np.asarray(m_r))
    got = port.plan_drops(batch, device="cpu")
    assert got == ref.plan_drops(ref.DropBatch(*batch))
    assert pc.check_drops(batch, port.plan_drop_rounds(batch, device="cpu")) == len(got) > 0


def test_drop_never_the_last_replica_and_empty():
    batch = port.DropBatch(np.asarray([[True, True, False]]), np.zeros((1, 3), bool),
                           np.asarray([100.0], np.float32), np.asarray([5], np.int32),
                           np.asarray([100.0, 100.0, 0.0], np.float32))
    assert len(port.plan_drops(batch, device="cpu")) == 1
    empty = port.DropBatch(np.zeros((0, 4), bool), np.zeros((0, 4), bool), np.zeros(0, np.float32),
                           np.zeros(0, np.int32), np.zeros(4, np.float32))
    assert port.plan_drops(empty, device="cpu") == []


def test_rows_without_an_eligible_holder_drop_nothing():
    """Every holder excluded: the score row is all -inf, argmax picks worker
    0, and ``ok`` must stay false there (ops/amm.py:54-56)."""
    holders = np.zeros((4, 6), bool)
    holders[:, 2:5] = True
    excluded = holders.copy()
    excluded[1, 3] = False
    batch = port.DropBatch(holders, excluded, np.full(4, 10.0, np.float32),
                           np.full(4, 2, np.int32), np.arange(6, dtype=np.float32))
    got = port.plan_drops(batch, device="cpu")
    assert got == ref.plan_drops(ref.DropBatch(*batch)) == [(1, 3)]


def _drop_rounds_by_lists(batch, rounds, shuffle=None):
    """K8's rule (csrc/amm_drop.cu) in numpy: each row's eligible holders
    listed once; a round's pick is the first maximum of the round-start
    memory over the row's list, ties to the lowest worker, and drops only
    if that memory is above -inf or the worker is 0 (the dense argmax of
    an all -inf row); the dropped holder leaves the list, the last entry
    taking its place; the bytes shed summed in row order.  ``shuffle``, a
    generator, permutes each list first: its order must not matter."""
    holders, excluded, nbytes, ndrop, mem = (np.asarray(a) for a in batch)
    R, W = holders.shape
    nrep, left = holders.sum(1), ndrop.astype(np.int64).copy()
    mem = mem.astype(np.float32).copy()
    lists = [list(np.flatnonzero(holders[r] & ~excluded[r])) for r in range(R)]
    if shuffle is not None:
        lists = [list(shuffle.permutation(lst)) for lst in lists]
    drops = np.full((R, rounds), -1, np.int32)
    for k in range(rounds):
        picks = []
        for r, lst in enumerate(lists):
            if not lst or left[r] <= 0 or nrep[r] <= 1:
                continue
            best, bi, at = np.float32(-np.inf), W, -1
            for j, w in enumerate(lst):
                if mem[w] > best or (mem[w] == best and w < bi):
                    best, bi, at = mem[w], w, j
            if best == -np.inf and bi != 0:
                continue
            lst[at] = lst[-1]
            lst.pop()
            left[r] -= 1
            nrep[r] -= 1
            drops[r, k] = bi
            picks.append((r, bi))
        shed = np.zeros(W, np.float32)
        for r, w in picks:
            shed[w] = np.float32(shed[w] + nbytes[r])
        mem = np.maximum(mem - shed, np.float32(0))
    return drops, mem


def _list_cases():
    rng = np.random.default_rng
    out = {"reference0": _reference_family(0), "reference_wide": _reference_family(7, R=500, W=64)}
    for R, W in ((300, 45), (400, 100)):
        out[f"amm{R}x{W}"] = pc.drop_round(rng(R + W), R, W, max_holders=min(64, W))
    # ties: memory of a few distinct values
    b = pc.drop_round(rng(5), 300, 70, max_holders=40)
    out["ties"] = b._replace(mem=rng(6).integers(0, 3, 70).astype(np.float32) * 1e6,
                             nbytes=np.full(300, 1e6, np.float32))
    # rows held by all W workers, a few with every holder excluded
    W = 37
    holders = np.ones((60, W), bool)
    excluded = rng(7).random((60, W)) < 0.2
    excluded[:5] = True
    out["all_held"] = port.DropBatch(holders, excluded, rng(8).uniform(1e3, 1e6, 60).astype(np.float32),
                                     rng(9).integers(1, W, 60).astype(np.int32),
                                     rng(10).uniform(0, 1e7, W).astype(np.float32))
    # -inf memory: a row whose eligible holders are all at -inf drops only
    # from worker 0 (rows 0-4, first round: no drop, 0, no drop, 4, no drop)
    b = _reference_family(11, R=80, W=12)
    mem = b.mem.copy()
    mem[[0, 3, 5, 6, 7]] = -np.inf
    mem[[1, 2]] = np.float32(5e5)
    held = np.zeros((5, 12), bool)
    out_of_use = np.zeros((5, 12), bool)
    for r, (h, e) in enumerate((({1, 3, 5}, {1}), ({0, 6}, ()), ({0, 3}, {0}), ({2, 3, 4}, ()),
                                ({3, 5, 6}, ()))):
        held[r, list(h)] = True
        out_of_use[r, list(e)] = True
    out["neg_inf"] = port.DropBatch(np.concatenate([held, b.holders]),
                                    np.concatenate([out_of_use, b.excluded]),
                                    np.concatenate([np.full(5, 1e3, np.float32), b.nbytes]),
                                    np.concatenate([np.full(5, 2, np.int32), b.ndrop]), mem)
    return out


@pytest.mark.parametrize("shuffled", [False, True])
@pytest.mark.parametrize("name", list(_list_cases()))
def test_compact_list_picks_equal_the_dense_argmax(name, shuffled):
    """K8's picks from per-row lists of eligible holders, with the dropped
    holder removed, equal the plain version's dense first argmax round
    after round, drops and memory, on ties, rows without an eligible
    holder, rows held by every worker, W not a multiple of 32 and -inf
    memory; in any order of the lists."""
    batch = _list_cases()[name]
    K = 64
    want = port.drop_rounds_reference(*(torch.from_numpy(np.asarray(a)) for a in batch), K)
    got = _drop_rounds_by_lists(batch, K, np.random.default_rng(1) if shuffled else None)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    assert (got[0] >= 0).sum() > 0


def test_plan_drops_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.plan_drops(_reference_family(0))


# ------------------------------------------------------------ sans-io


def _amm_state():
    """tests/test_mirror.py's shared-fleet AMM scene: four memory keys on
    one worker, replicated to two more."""
    state = _state(n_workers=6, nthreads=1)
    sched = StubScheduler(state)
    amm = ActiveMemoryManagerExtension(sched, policies=[ReduceReplicas()], register=False,
                                       start=False)
    for i in range(4):
        key = f"mem-{i}"
        state.new_task(key, None).priority = (0,)
        state._transition(key, "memory", "seed", nbytes=1000, worker=list(state.workers)[0])
        for ws in list(state.workers.values())[1:3]:
            state.add_replica(state.tasks[key], ws)
    return state, sched, amm


def _removals(sched):
    return sorted((addr, tuple(sorted(msg["keys"]))) for _, wmsgs in sched.sent
                  for addr, msgs in wmsgs.items() for msg in msgs if msg["op"] == "remove-replicas")


def test_sans_io_round_equals_reference_device_round():
    """The port's round sends the reference's device round's removals; the
    mirror is the port's, and nothing falls back to a python pack."""
    with config.set({"scheduler.jax.min-workers": 0, "scheduler.jax.periodic-min-workers": 0}):
        r_state, r_sched, r_amm = _amm_state()
        policy = next(iter(r_amm.policies))
        policy.DEVICE_MIN_TASKS = 1
        r_amm.run_once()
    state, sched, amm = _amm_state()
    policy = next(iter(amm.policies))
    policy.DEVICE_MIN_TASKS = 1
    path = install_amm(policy, device="cpu", min_workers=0, periodic_min_workers=0)
    TorchMirror.adopt(state, device="cpu")
    amm.run_once()
    assert _removals(sched) == _removals(r_sched) != []
    assert path.counters() == {"launches": 1, "failures": 0, "cycles_device": 1, "cycles_host": 0}
    assert state.mirror.oracle_packs == 0


def test_sans_io_gate_keeps_small_fleets_on_the_host():
    state, sched, amm = _amm_state()
    path = install_amm(next(iter(amm.policies)), device="cpu")
    amm.run_once()
    assert path.counters() == {"launches": 0, "failures": 0, "cycles_device": 0, "cycles_host": 1}
    assert _removals(sched)


def test_planted_failure_propagates_from_the_generator(monkeypatch):
    """The plan raises: the policy's generator raises it (the manager then
    logs a failing policy, as for any), the path counts and keeps it, and
    no python drop is suggested in its place."""
    state, sched, amm = _amm_state()
    policy = next(iter(amm.policies))
    policy.DEVICE_MIN_TASKS = 1
    path = install_amm(policy, device="cpu", min_workers=0, periodic_min_workers=0)
    boom = RuntimeError("planted")

    def fail(*args, **kwargs):
        raise boom

    monkeypatch.setattr(port, "plan_drops", fail)
    amm.pending = {}
    with pytest.raises(RuntimeError, match="planted"):
        list(policy.run())
    assert path.failures == 1 and path.errors == [boom] and path.cycles_host == 0
    amm.run_once()
    assert path.failures == 2 and not _removals(sched)


# ------------------------------------------------------------- live


@gen_test(timeout=120)
async def test_device_amm_drop_live_with_the_port():
    """tests/test_ops_stealing_amm.py's live AMM round with the port's paths
    installed: broadcast replicas beyond demand are trimmed by the port's
    plan, and the data stays gatherable."""
    from distributed_tpu.client.client import Client
    from distributed_tpu.deploy.local import LocalCluster

    async with LocalCluster(n_workers=4, threads_per_worker=1) as cluster:
        handle = install_periodic(cluster.scheduler, device="cpu", min_workers=0,
                                  periodic_min_workers=0)
        amm = cluster.scheduler.extensions["amm"]
        next(p for p in amm.policies if isinstance(p, ReduceReplicas)).DEVICE_MIN_TASKS = 1
        async with Client(cluster.scheduler_address) as c:
            futs = await c.scatter(list(range(6)), broadcast=True)
            state = cluster.scheduler.state
            for _ in range(100):
                if len(state.replicated_tasks) >= 6:
                    break
                await asyncio.sleep(0.05)
            assert state.replicated_tasks
            n_before = sum(len(state.tasks[f.key].who_has) for f in futs)
            amm.run_once()
            for _ in range(100):
                await asyncio.sleep(0.05)
                if sum(len(state.tasks[f.key].who_has) for f in futs) < n_before:
                    break
            else:
                pytest.fail("the port's AMM round dropped nothing")
            assert await c.gather(futs) == list(range(6))
        assert handle.amm.launches > 0 and handle.failures == 0
