"""``TorchPlacement`` reads the port's ``scheduler.jax`` configuration as
the reference's ``JaxPlacement`` reads the reference's
(``distributed_tpu/scheduler/jax_placement.py:160-201``, and the
partitioner at each plan, ``:780``): the same override dict gives both
placements the same values, an explicit argument wins in both, and a
scheduler built with no placement plans what the reference's plans."""

from __future__ import annotations

import asyncio

import numpy as np
import pytest
import torch

from distributed_tpu import config as ref_config
from distributed_tpu.graph.spec import TaskSpec as RefTaskSpec
from distributed_tpu.scheduler.jax_placement import JaxPlacement
from distributed_tpu.scheduler.server import Scheduler as RefScheduler
from distributed_tpu_torch import config
from distributed_tpu_torch.graph.spec import TaskSpec
from distributed_tpu_torch.ops import partition as part
from distributed_tpu_torch.scheduler.server import Scheduler
from distributed_tpu_torch.scheduler.torch_placement import TorchPlacement

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
torch.set_num_threads(2)

#: every ``scheduler.jax`` key the placement reads, away from its default
KEYS = {
    "scheduler.jax.min-batch": 64,
    "scheduler.jax.min-workers": 0,
    "scheduler.jax.sync-plan": True,
    "scheduler.jax.min-transfer-ratio": 0.5,
    "scheduler.jax.home-depth": 3,
    "scheduler.jax.drift-yield": False,
    "scheduler.jax.partitioner": "numpy",
    "scheduler.jax.mesh.enabled": False,
    "scheduler.jax.mesh.devices": 2,
    "scheduler.jax.mesh.layout": "2x1",
}
ATTRS = ("min_batch", "max_batch", "min_workers", "sync", "min_transfer_ratio",
         "home_depth", "drift_yield", "mesh_enabled", "mesh_devices", "mesh_layout")


def _values(placement) -> dict:
    return {a: getattr(placement, a) for a in ATTRS}


def test_defaults_are_the_references():
    assert _values(TorchPlacement(device="cpu")) == _values(JaxPlacement())


def test_one_override_dict_sets_both_placements():
    with ref_config.set(KEYS), config.set(KEYS):
        ref, port = JaxPlacement(), TorchPlacement(device="cpu")
    assert _values(port) == _values(ref)
    assert _values(port) == {
        "min_batch": 64, "max_batch": 1_000_000, "min_workers": 0, "sync": True,
        "min_transfer_ratio": 0.5, "home_depth": 3, "drift_yield": False,
        "mesh_enabled": False, "mesh_devices": 2, "mesh_layout": "2x1",
    }


def test_an_explicit_argument_wins_over_the_configuration():
    explicit = {"min_batch": 7, "min_workers": 3, "sync": False, "min_transfer_ratio": 0.0,
                "home_depth": "inf", "drift_yield": True}
    with ref_config.set(KEYS), config.set(KEYS):
        ref = JaxPlacement(**{k: explicit[k] for k in
                              ("min_batch", "min_workers", "sync", "min_transfer_ratio")})
        port = TorchPlacement(device="cpu", **explicit)
    for name in ("min_batch", "min_workers", "sync", "min_transfer_ratio"):
        assert getattr(port, name) == getattr(ref, name) == explicit[name]
    assert port.home_depth is None and port.drift_yield is True


@pytest.mark.parametrize("partitioner", ["numpy", "off"])
def test_the_partitioner_is_read_at_plan_time(partitioner, monkeypatch):
    """Built before the override and planning under it, the placement
    takes the configured engine, as the reference's does: ``numpy`` calls
    the numpy partitioner, ``off`` never calls a partitioner."""
    calls = []

    def spy(name):
        real = getattr(part, name)

        def counted(*args, **kwargs):
            calls.append(name)
            return real(*args, **kwargs)
        return counted

    for name in ("partition_numpy", "partition_padded"):
        monkeypatch.setattr(part, name, spy(name))
    placement = TorchPlacement(device="cpu")
    rng = np.random.default_rng(5)
    T, W = 64, 4
    src = np.arange(T - 1, dtype=np.int32)
    dst = src + 1
    args = ([f"t-{i}" for i in range(T)], rng.uniform(0.01, 0.1, T).astype(np.float32),
            np.full(T, 1e6, np.float32), src, dst, np.full(W, 2, np.int32),
            np.zeros(W, np.float32), np.ones(W, bool), [f"tcp://w:{w}" for w in range(W)],
            100e6, 0.0005)
    with config.set({"scheduler.jax.partitioner": partitioner}):
        placement._plan_from_arrays(*args)
    assert calls == (["partition_numpy"] if partitioner == "numpy" else [])
    with config.set({"scheduler.jax.partitioner": "jax"}), pytest.raises(ValueError):
        placement._plan_from_arrays(*args)


def _inc(x):
    return x + 1


def _plan_a_graph(scheduler_cls, spec, cfg, **kw):
    """A scheduler built with no placement, 4 two-thread workers and a
    100-task graph under ``min-batch`` 64 and ``min-workers`` 0."""
    with cfg.set({"scheduler.jax.enabled": True, "scheduler.jax.min-batch": 64,
                  "scheduler.jax.min-workers": 0, "scheduler.jax.sync-plan": True}):
        state = scheduler_cls(**kw).state
        for i in range(4):
            state.add_worker_state(f"tcp://w:{i}", nthreads=2, memory_limit=2**30, name=f"w{i}")
        tasks, deps = {}, {}
        for i in range(50):
            tasks[f"a-{i}"], deps[f"a-{i}"] = spec(_inc, (i,)), set()
            tasks[f"b-{i}"], deps[f"b-{i}"] = spec(_inc, (i,)), {f"a-{i}"}
        state.update_graph_core(tasks, deps, list(tasks), client="t", stimulus_id="plan")
    return state.placement


def test_a_scheduler_with_no_placement_plans_as_the_references():
    async def run():
        return (_plan_a_graph(RefScheduler, RefTaskSpec, ref_config),
                _plan_a_graph(Scheduler, TaskSpec, config, device="cpu"))

    ref, port = asyncio.run(run())
    assert isinstance(port, TorchPlacement)
    assert (port.min_batch, port.min_workers, port.sync) == (64, 0, True)
    assert port.plans_computed == ref.plans_computed == 1
    assert len(port.plan) == len(ref.plan) > 0
    assert port.plan == ref.plan
