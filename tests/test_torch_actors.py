"""The port's client extras (``client/actor.py``, ``client/worker_client.py``,
``client/cfexecutor.py``) against the reference's, on the CPU.

The five scenarios of ``tests/test_actors.py`` run on a reference
``LocalCluster`` and on the port's (``device="cpu"``), and their outcomes
must be equal; so must a task that submits and gathers sub-tasks through
``worker_client()`` and a ``client.get_executor().map``.  The port's
actor results are held on torch tensors too: an accumulator of CPU
tensors takes the same adds as the reference's numpy one.

Actor classes and task functions live in this module: the port has no
cloudpickle.
"""

from __future__ import annotations

import asyncio
import operator

import numpy as np
import pytest
import torch

from distributed_tpu.client import actor as ref_actor
from distributed_tpu.client.client import Client as RefClient
from distributed_tpu.client.client import as_completed as ref_as_completed
from distributed_tpu.deploy.local import LocalCluster as RefLocalCluster
from distributed_tpu_torch.client import actor
from distributed_tpu_torch.client.client import Client, as_completed
from distributed_tpu_torch.client.worker_client import rejoin, secede, worker_client
from distributed_tpu_torch.deploy.local import LocalCluster

from conftest import gen_test

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)


class Counter:
    def __init__(self, start=0):
        self.n = start

    def increment(self, by=1):
        self.n += by
        return self.n

    def value(self):
        return self.n


class Bad:
    def boom(self):
        raise RuntimeError("actor-boom")


class Accumulator:
    """A running sum of seeded blocks, as a torch tensor or a numpy array."""

    def __init__(self, kind, n=64):
        self.kind = kind
        self.total = torch.zeros(n, dtype=torch.float64) if kind == "torch" else np.zeros(n)

    def add(self, seed):
        b = seeded_block(seed, len(self.total))
        self.total += torch.from_numpy(b) if self.kind == "torch" else b
        return float(self.total.sum())

    def value(self):
        return np.asarray(self.total).tobytes()


def seeded_block(seed, n=64):
    return np.random.default_rng(seed).integers(0, 8, n).astype(np.float64)


def forty_one():
    return 41


def double(x):
    return 2 * x


def parent(n, package="port"):
    """Submits ``n`` sub-tasks from inside a task and gathers them, through
    ``package``'s ``worker_client``."""
    if package == "port":
        open_client = worker_client
    else:
        from distributed_tpu.client.worker_client import worker_client as open_client
    with open_client() as wc:
        futs = [wc.submit(double, i, pure=False) for i in range(n)]
        return sorted(wc.gather_sync(futs))


def block_sum(seed):
    return float(seeded_block(seed).sum())


def seceded_then_rejoined():
    from distributed_tpu_torch.worker.context import get_worker

    ex = get_worker().executor
    before = ex._max_workers
    secede()
    during = ex._max_workers
    rejoin()
    return before, during, ex._max_workers


class Package:
    def __init__(self, name, cluster, client, as_completed, actor_module):
        self.name, self.LocalCluster, self.Client = name, cluster, client
        self.as_completed, self.actor = as_completed, actor_module


REF = Package("reference", RefLocalCluster, RefClient, ref_as_completed, ref_actor)
PORT = Package("port", LocalCluster, Client, as_completed, actor)


def new_cluster(pkg, n_workers=2, threads_per_worker=1, protocol="inproc"):
    kw = dict(n_workers=n_workers, threads_per_worker=threads_per_worker, protocol=protocol,
              scheduler_kwargs={"validate": True}, worker_kwargs={"validate": True})
    if pkg is PORT:
        return LocalCluster(device="cpu", **kw)
    kw["scheduler_kwargs"]["http_port"] = kw["worker_kwargs"]["http_port"] = None
    return RefLocalCluster(**kw)


async def actor_basic(pkg):
    async with new_cluster(pkg) as cluster:
        async with pkg.Client(cluster.scheduler_address) as c:
            fut = c.submit(Counter, actor=True)
            counter = await fut.result()
            return (type(counter).__name__, await counter.increment(),
                    await counter.increment(by=10), await counter.value(), await counter.n)


async def actor_state_is_pinned(pkg):
    async with new_cluster(pkg) as cluster:
        async with pkg.Client(cluster.scheduler_address) as c:
            fut = c.submit(Counter, 100, actor=True)
            counter = await fut.result()
            for _ in range(5):
                await counter.increment()
            hosts = [w for w in cluster.workers if w.state.actors]
            ph = hosts[0].data[fut.key]
            return (await counter.value(), len(hosts), type(ph).__name__,
                    ph.worker == hosts[0].address, ph.cls is Counter)


async def actor_method_error(pkg):
    async with new_cluster(pkg, n_workers=1) as cluster:
        async with pkg.Client(cluster.scheduler_address) as c:
            fut = c.submit(Bad, actor=True)  # hold: the actor lives with its future
            a = await fut.result()
            with pytest.raises(RuntimeError, match="actor-boom") as info:
                await a.boom()
            return type(info.value), info.value.args


async def two_actors_independent(pkg):
    async with new_cluster(pkg) as cluster:
        async with pkg.Client(cluster.scheduler_address) as c:
            fa = c.submit(Counter, 0, actor=True, key="actor-a")
            fb = c.submit(Counter, 50, actor=True, key="actor-b")
            a, b = await fa.result(), await fb.result()
            await a.increment()
            await b.increment()
            return await a.value(), await b.value()


async def actor_futures_and_as_completed(pkg):
    async with new_cluster(pkg) as cluster:
        async with pkg.Client(cluster.scheduler_address) as c:
            fut = c.submit(Counter, actor=True)
            counter = await fut.result()
            af = counter.increment()
            fired = []
            af.add_done_callback(lambda t: fired.append(True))
            first = await af
            await asyncio.sleep(0)
            tfut = c.submit(forty_one, pure=False)
            got = [r async for _, r in pkg.as_completed(
                [counter.increment(), tfut, counter.increment()], with_results=True)]
            return (isinstance(af, pkg.actor.ActorFuture), first, af.done(), fired,
                    sorted(got), await counter.value())


ACTOR_SCENARIOS = {f.__name__: f for f in (actor_basic, actor_state_is_pinned, actor_method_error,
                                            two_actors_independent,
                                            actor_futures_and_as_completed)}
WANT = {"actor_basic": ("Actor", 1, 11, 11, 11),
        "actor_state_is_pinned": (105, 1, "ActorPlaceholder", True, True),
        "actor_method_error": (RuntimeError, ("actor-boom",)),
        "two_actors_independent": (1, 51),
        "actor_futures_and_as_completed": (True, 1, True, [True], [2, 3, 41], 3)}


@pytest.mark.parametrize("scenario", sorted(ACTOR_SCENARIOS))
@gen_test(timeout=120)
async def test_actors_give_the_references_outcome(scenario):
    run = ACTOR_SCENARIOS[scenario]
    ref = await run(REF)
    port = await run(PORT)
    assert port == ref == WANT[scenario]


async def accumulate(pkg, kind, n_adds=100, protocol="inproc"):
    async with new_cluster(pkg, protocol=protocol) as cluster:
        async with pkg.Client(cluster.scheduler_address) as c:
            fut = c.submit(Accumulator, kind, actor=True)
            acc = await fut.result()
            sums = [await acc.add(seed) for seed in range(n_adds)]
            return sums, await acc.value()


@pytest.mark.parametrize("protocol", ["inproc", "tcp"])
@gen_test(timeout=120)
async def test_a_tensor_accumulator_equals_the_references(protocol):
    """Over tcp the calls and their results cross the port's wire."""
    want = await accumulate(REF, "numpy", protocol=protocol)
    got = await accumulate(PORT, "torch", protocol=protocol)
    assert got == want
    expected = sum(seeded_block(s) for s in range(100))
    assert got[1] == expected.tobytes()


def test_the_placeholder_pickles_by_reference():
    import pickle

    ph = actor.ActorPlaceholder(Counter, "k", "inproc://w")
    back = pickle.loads(pickle.dumps(ph))
    assert (back.cls, back.key, back.worker) == (Counter, "k", "inproc://w")
    assert repr(back) == repr(ref_actor.ActorPlaceholder(Counter, "k", "inproc://w"))


# ------------------------------------------------------------ worker_client, executor


async def subtasks(pkg):
    async with new_cluster(pkg, threads_per_worker=1) as cluster:
        async with pkg.Client(cluster.scheduler_address) as c:
            return await asyncio.wait_for(c.submit(parent, 16, pkg.name).result(), 60)


@gen_test(timeout=120)
async def test_worker_client_gives_the_references_subtasks():
    got = await subtasks(PORT)
    assert got == await subtasks(REF) == [2 * i for i in range(16)]


@gen_test(timeout=60)
async def test_secede_grows_the_pool_and_rejoin_shrinks_it():
    async with new_cluster(PORT, n_workers=1, threads_per_worker=2) as cluster:
        async with Client(cluster.scheduler_address) as c:
            assert await c.submit(seceded_then_rejoined).result() == (2, 3, 2)


async def executor_map(pkg, n=32):
    async with new_cluster(pkg) as cluster:
        async with pkg.Client(cluster.scheduler_address) as c:
            ex = c.get_executor()
            gen = ex.map(block_sum, range(n))  # submits on the loop
            out = await asyncio.get_running_loop().run_in_executor(None, list, gen)
            single = ex.submit(operator.add, 40, 2)
            one = await asyncio.get_running_loop().run_in_executor(None, single.result, 30)
            ex.shutdown(wait=False)
            with pytest.raises(RuntimeError, match="shut down"):
                ex.submit(forty_one)
            return type(ex).__name__, out, one


@gen_test(timeout=120)
async def test_the_executor_maps_as_the_references():
    got = await executor_map(PORT)
    assert got == await executor_map(REF)
    assert got == ("ClientExecutor", [block_sum(i) for i in range(32)], 42)
