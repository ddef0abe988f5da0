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
"""

from __future__ import annotations

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
