"""The port's placement extension (``distributed_tpu_torch/scheduler/
torch_placement.py``) against the reference's ``JaxPlacement``, on the CPU.

- ``_plan_from_arrays`` on both branches (the partitioner and the leveled
  engine) and on the numpy engine: the same hint dict as the reference's,
  tolerance none.
- Hint consumption (hit / park / yield) on a bare ``SchedulerState``.
- Live ``LocalCluster`` runs with ``TorchPlacement(device="cpu")``
  injected through ``scheduler_kwargs["placement"]``: results, plan
  counters, worker death, and the partitioner's locality against a run
  without a plan.  Each asserts that the planner is still enabled (a
  failed plan disables it).  These need the reference's control plane
  (``msgpack``, ``cloudpickle``), which the card's machine does not have,
  so they run on the CPU only.
"""

from __future__ import annotations

import asyncio
import math

import numpy as np
import pytest

from distributed_tpu import config
from distributed_tpu.client.client import Client
from distributed_tpu.deploy.local import LocalCluster
from distributed_tpu.graph.spec import Graph, TaskRef, TaskSpec
from distributed_tpu.ops import partition as jpart
from distributed_tpu.scheduler.jax_placement import JaxPlacement
from distributed_tpu.scheduler.state import SchedulerState
from distributed_tpu_torch import graphs
from distributed_tpu_torch.ops import partition as tpart
from distributed_tpu_torch.scheduler.torch_placement import TorchPlacement

from conftest import gen_test
from test_leveled import random_dag


def _fleet(W, seed):
    """Non-uniform: 1-4 threads, random occupancy, a few stopped workers."""
    rng = np.random.default_rng(seed)
    running = np.ones(W, bool)
    running[rng.choice(W, max(W // 8, 1), replace=False)] = False
    return (rng.integers(1, 5, W).astype(np.int32),
            rng.uniform(0, 5, W).astype(np.float32), running)


def _args(graph, fleet, latency=0.0005):
    durations, out_bytes, src, dst = graph
    T, W = len(durations), len(fleet[0])
    keys = [f"task-{i}" for i in range(T)]
    addrs = [f"tcp://10.0.0.{w}:8788" for w in range(W)]
    return (keys, durations, out_bytes, src, dst, *fleet, addrs, 100e6, latency)


def _reference(args, partitioner):
    placement = JaxPlacement(min_batch=4, min_workers=0, sync=True)
    placement.mesh_enabled = False
    with config.set({"scheduler.jax.partitioner": partitioner}):
        plan, shards = placement._plan_from_arrays(*args)
    assert shards is None
    return plan


GRAPHS = {
    "random3000": lambda: random_dag(np.random.default_rng(41), 3000),
    "blockwise8": lambda: graphs.blockwise_tensordot(8)[1:],
}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("partitioner", ["auto", "numpy", "off"])
def test_plan_from_arrays_equals_reference(graph, partitioner):
    """``auto`` and ``numpy`` take the partitioner (absolute homes),
    ``off`` the leveled engine (follow hints); tolerance none."""
    args = _args(GRAPHS[graph](), _fleet(12, 3))
    want = _reference(args, partitioner)
    got = TorchPlacement(partitioner=partitioner, device="cpu")._plan_from_arrays(*args)
    assert got == want
    assert len(got) == len(args[0])
    follows = sum(f is not None for f, _ in got.values())
    assert (follows > 0) == (partitioner == "off")


def test_dense_limit_routes_to_the_leveled_engine(monkeypatch):
    """A batch whose padded task count times the lanes passes DENSE_LIMIT
    goes to the leveled engine on both sides."""
    args = _args(random_dag(np.random.default_rng(42), 2000), _fleet(10, 4))
    lanes = int(args[5][args[7]].clip(min=1).sum())
    limit = tpart._bucket(2000) * lanes - 1
    monkeypatch.setattr(jpart, "DENSE_LIMIT", limit)
    monkeypatch.setattr(tpart, "DENSE_LIMIT", limit)
    got = TorchPlacement(device="cpu")._plan_from_arrays(*args)
    assert got == _reference(args, "auto")
    assert any(f is not None for f, _ in got.values())
    monkeypatch.setattr(tpart, "DENSE_LIMIT", limit + 1)
    assert all(f is None for f, _ in
               TorchPlacement(device="cpu")._plan_from_arrays(*args).values())


def test_partitioner_failure_propagates(monkeypatch):
    """No numpy fallback: a failed device partition reaches the caller
    (``plan_graph``'s handler logs it and disables the planner)."""

    def broken(*a, **k):
        raise RuntimeError("kernel broke")

    monkeypatch.setattr(tpart, "partition_padded", broken)
    args = _args(random_dag(np.random.default_rng(43), 500), _fleet(6, 5))
    with pytest.raises(RuntimeError, match="kernel broke"):
        TorchPlacement(device="cpu")._plan_from_arrays(*args)


def test_constructor_checks_its_arguments():
    with pytest.raises(ValueError, match="partitioner"):
        TorchPlacement(partitioner="jax", device="cpu")
    p = TorchPlacement(home_depth=2, device="cpu")
    assert p.home_depth == 2 and p.min_batch == 512 and p.min_workers == 8
    assert TorchPlacement(device="cpu").home_depth is None


def test_hint_resolution_hit_park_yield():
    """Three-verdict hint consumption (finite home-depth): open slot ->
    hit; home stacked to depth but backlog in line with the cluster
    average -> park; home an extreme backlog outlier with a tiny dep ->
    yield to an idle worker; a huge dep keeps the task bound to its home
    (park) even then.  A copy of the reference's test."""
    state = SchedulerState(validate=True)
    placement = TorchPlacement(min_batch=1, min_workers=0, sync=True, home_depth=0,
                               drift_yield=True, device="cpu")
    busy = state.add_worker_state("tcp://h:1", nthreads=1, memory_limit=2**30)
    idle = state.add_worker_state("tcp://h:2", nthreads=1, memory_limit=2**30)
    state.check_idle_saturated(busy)
    state.check_idle_saturated(idle)

    dep = state.new_task("dep-1", None, "released")
    dep.state = "memory"
    dep.who_has.add(busy)
    busy.has_what[dep] = None
    ts = state.new_task("child-1", None, "released")
    ts.add_dependency(dep)

    placement.plan = {ts.key: (dep.key, busy.address)}
    assert placement.resolve(state, ts, None) == ("hit", busy)
    assert placement.plan_hits == 1

    depth = math.ceil(busy.nthreads * state.WORKER_SATURATION)
    for i in range(depth):
        filler = state.new_task(f"filler-{i}", None, "released")
        busy.processing[filler] = 0.001
    state.idle.pop(busy.address, None)
    state.idle_task_count.discard(busy)
    assert idle.address in state.idle

    busy.occupancy = 0.002
    state._total_occupancy = 0.002
    dep.nbytes = 1
    placement.plan = {ts.key: (dep.key, busy.address)}
    assert placement.resolve(state, ts, None) == ("park", busy)
    assert placement.plan_parks == 1
    assert ts.key in placement.plan

    busy.occupancy = 10.0
    state._total_occupancy = 10.0
    placement.plan = {ts.key: (dep.key, busy.address)}
    assert placement.resolve(state, ts, None) == ("miss", None)
    assert placement.plan_misses == 1 and placement.miss_reasons["idle-yield"] == 1

    dep.nbytes = int(state.bandwidth * 100)
    placement.plan = {ts.key: (dep.key, busy.address)}
    assert placement.resolve(state, ts, None) == ("park", busy)

    # the legacy entry consumes a would-be park as a miss
    assert placement.decide_worker(state, ts, None) is None
    assert placement.miss_reasons["park-declined"] == 1 and ts.key not in placement.plan


# ------------------------------------------------------------------ live


def inc(x):
    return x + 1


def _chains(prefix, n, fn=inc):
    g = Graph()
    keys = []
    for i in range(n):
        g.tasks[f"{prefix}src{i}-x"] = TaskSpec(fn, (i,))
        g.tasks[f"{prefix}out{i}-x"] = TaskSpec(inc, (TaskRef(f"{prefix}src{i}-x"),))
        keys.append(f"{prefix}out{i}-x")
    return g, keys


def _placement(**kw):
    return TorchPlacement(min_batch=4, min_workers=0, min_transfer_ratio=0,
                          partitioner="auto", device="cpu", **kw)


@gen_test(timeout=120)
async def test_plan_consumed_and_results_correct():
    placement = _placement(sync=True)
    async with LocalCluster(
        n_workers=2,
        scheduler_kwargs={"validate": True, "placement": placement},
        worker_kwargs={"validate": True},
    ) as cluster:
        assert cluster.scheduler.state.placement is placement
        async with Client(cluster.scheduler_address) as c:
            g, keys = _chains("t", 6)
            futs = c.compute_graph(g, keys)
            results = await asyncio.wait_for(c.gather([futs[k] for k in keys]), 60)
            assert results == [i + 2 for i in range(6)]
            assert placement.plans_computed >= 1
            assert placement.plan_hits > 0
            assert placement.enabled


@gen_test(timeout=120)
async def test_async_plan_lands_mid_execution():
    """Planning off the loop: the plan serves the layer that becomes
    ready after it lands."""
    import time as _time

    placement = _placement()
    assert not placement.sync

    def slow_inc(x):
        _time.sleep(0.5)
        return x + 1

    async with LocalCluster(
        n_workers=2,
        scheduler_kwargs={"validate": True, "placement": placement},
        worker_kwargs={"validate": True},
    ) as cluster:
        async with Client(cluster.scheduler_address) as c:
            g, keys = _chains("ta", 6, slow_inc)
            futs = c.compute_graph(g, keys)
            results = await asyncio.wait_for(c.gather([futs[k] for k in keys]), 60)
            assert results == [i + 2 for i in range(6)]
            assert placement.plans_computed >= 1
            assert placement.plan_hits > 0
            assert placement.planner_ident() is not None
            assert placement.enabled


@gen_test(timeout=120)
async def test_plan_fallback_when_worker_dies():
    placement = _placement(sync=True)
    async with LocalCluster(
        n_workers=2,
        scheduler_kwargs={"validate": True, "placement": placement},
        worker_kwargs={"validate": True},
    ) as cluster:
        async with Client(cluster.scheduler_address) as c:
            g, keys = _chains("tfb", 4)
            futs = c.compute_graph(g, keys)
            assert await asyncio.wait_for(
                c.gather([futs[k] for k in keys]), 60) == [i + 2 for i in range(4)]
            victim = cluster.workers[0]
            await victim.close(report=False)
            cluster.workers = cluster.workers[1:]
            assert all(
                follow is not None or addr != victim.address
                for follow, addr in placement.plan.values()
            )
            futs2 = c.map(inc, range(8), pure=False)
            assert await asyncio.wait_for(c.gather(futs2), 60) == list(range(1, 9))
            assert placement.plans_computed >= 1
            assert placement.enabled


def mul(a, b):
    return a * b


def red(*xs):
    return sum(xs)


def test_live_planner_partitions_and_wins_locality():
    """The reference's locality test with the port's planner: a blockwise
    graph on 8 one-thread workers, planned by the partitioner (the plain
    version of K4 on the CPU) and consumed through deep home stacks, must
    serve fewer than 0.75x the peer fetches of a run without a plan."""

    async def run(placement):
        async with LocalCluster(n_workers=8, threads_per_worker=1,
                                scheduler_kwargs={"placement": placement}) as cluster:
            async with Client(cluster.scheduler_address) as c:
                G = 8
                g = Graph()
                outs = []
                for i in range(G):
                    for k in range(G):
                        g.tasks[f"s-{i}-{k}"] = TaskSpec(mul, (i, k))
                for i in range(G):
                    for j in range(G):
                        for k in range(G):
                            g.tasks[f"m-{i}-{j}-{k}"] = TaskSpec(
                                mul, (TaskRef(f"s-{i}-{k}"), TaskRef(f"s-{j}-{k}")))
                        g.tasks[f"r-{i}-{j}"] = TaskSpec(
                            red, tuple(TaskRef(f"m-{i}-{j}-{k}") for k in range(G)))
                        outs.append(f"r-{i}-{j}")
                futs = c.compute_graph(g, outs)
                res = await asyncio.wait_for(c.gather([futs[k] for k in outs]), 120)
                assert res[0] == 0
                assert res[-1] == sum((7 * k) * (7 * k) for k in range(G))
                # close() turns the planner off: read it while the cluster runs
                enabled = placement is False or placement.enabled
                served = sum(getattr(w, "get_data_keys_served", 0) for w in cluster.workers)
                return served, enabled

    async def main():
        import sys

        history = []
        for attempt in range(3):
            served_off, _ = await run(False)
            placement = TorchPlacement(min_batch=64, min_workers=0, min_transfer_ratio=0,
                                       sync=True, device="cpu")
            served_on, enabled = await run(placement)
            history.append((attempt, served_on, served_off, placement.plans_computed,
                            placement.plan_hits))
            print(f"# locality attempt {history[-1]}", file=sys.stderr)
            assert placement.plans_computed >= 1
            assert placement.plan_hits > 0
            assert enabled
            if served_on < 0.75 * served_off:
                return
        raise AssertionError(history)

    asyncio.run(main())
