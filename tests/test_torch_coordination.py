"""The port's coordination primitives
(``distributed_tpu_torch/coordination/extensions.py``, ``objects.py``)
against the reference's, on the CPU: the cases of
``tests/test_coordination.py`` run on both packages' clusters, each
scenario recording every outcome (acquired or not, values read, sizes,
timeouts, keys kept alive) in order.

Tolerance: none; each scenario's outcomes on the port's
``LocalCluster(device="cpu")`` equal the reference's, value for value.
The port's scheduler carries the reference's extension keys and their
handlers, and the client's dataset calls reach a real ``PublishExtension``.
"""

from __future__ import annotations

import asyncio

import pytest
import torch

from distributed_tpu.scheduler.server import default_extensions as ref_default_extensions
from distributed_tpu_torch.coordination import extensions
from distributed_tpu_torch.scheduler.server import default_extensions

from conftest import gen_test
from torch_shuffle_cases import PACKAGES, cluster_and_client, constant, slow_result, triple

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)


async def event(co, cluster, c, c2):
    ev = co.Event("my-event", client=c)
    out = [await ev.is_set(), await ev.wait(timeout=0.05)]

    async def setter():
        await asyncio.sleep(0.05)
        await co.Event("my-event", client=c2).set()

    task = asyncio.ensure_future(setter())
    out += [await ev.wait(timeout=5), await ev.is_set()]
    await ev.clear()
    out.append(await ev.is_set())
    await task
    return out


async def lock(co, cluster, c, c2):
    lock1, lock2 = co.Lock("x", client=c), co.Lock("x", client=c2)
    out = [await lock1.acquire(), await lock1.locked(), await lock2.acquire(timeout=0.05)]
    await lock1.release()
    out += [await lock2.acquire(timeout=5)]
    await lock2.release()
    async with co.Lock("y", client=c):
        out.append(await co.Lock("y", client=c2).locked())
    out.append(await co.Lock("y", client=c).locked())
    again = co.Lock("re", client=c)
    out += [await again.acquire(), await again.acquire(timeout=1)]  # reentrant: same id
    await again.release()
    try:
        await lock1.release()  # not held
    except Exception as exc:  # noqa: BLE001 - the remote error's type is compared
        out.append(type(exc).__name__)
    return out


async def multilock(co, cluster, c, c2):
    m1 = co.MultiLock(["a", "b"], client=c)
    out = [await m1.acquire()]
    m2 = co.MultiLock(["b", "c"], client=c2)
    out.append(await m2.acquire(timeout=0.05))  # blocked on b
    await m1.release()
    out.append(await m2.acquire(timeout=5))
    await m2.release()
    m3 = co.MultiLock(["a", "b", "c"], client=c)
    out.append(await m3.acquire(num_locks=2))
    out.append(await co.MultiLock(["c"], client=c2).acquire(timeout=0.05))  # c was let go
    await m3.release()
    return out


async def semaphore(co, cluster, c, c2):
    sem = co.Semaphore(max_leases=2, name="sem", client=c)
    out = [await sem.acquire(), await sem.acquire(), await sem.get_value(),
           await co.Semaphore(max_leases=2, name="sem", client=c2).acquire(timeout=0.05)]
    await sem.release()
    out += [await sem.acquire(timeout=5)]
    await sem.release()
    await sem.release()
    out.append(await sem.get_value())
    try:
        await sem.release()
    except ValueError as exc:
        out.append(str(exc))
    try:
        await co.Semaphore(max_leases=3, name="sem", client=c2).acquire()
    except Exception as exc:  # noqa: BLE001 - the remote error's type is compared
        out.append(type(exc).__name__)
    await sem.close()
    return out


async def queue_data(co, cluster, c, c2):
    q = co.Queue("q1", client=c)
    await q.put({"a": 1})
    await q.put(42)
    out = [await q.qsize(), await co.Queue("q1", client=c2).get(), await q.get()]
    try:
        await q.get(timeout=0.05)
    except asyncio.TimeoutError:
        out.append("timeout")
    await q.close()
    return out


async def queue_futures(co, cluster, c, c2):
    q = co.Queue("qf", client=c)
    fut = c.submit(triple, 5, key="qf-task")
    await fut.result()
    await q.put(fut)
    got = await co.Queue("qf", client=c2).get()
    return [got.key, await got.result()]


async def queue_future_pending(co, cluster, c, c2):
    """A future put before it finishes is awaited by another client."""
    fut = c.submit(slow_result, "slow-result", key="slow-task")
    await co.Queue("xq", client=c).put(fut)
    got = await co.Queue("xq", client=c2).get(timeout=5)
    return [got.key, await asyncio.wait_for(got.result(), 10)]


async def variable(co, cluster, c, c2):
    v = co.Variable("var1", client=c)
    out = []
    try:
        await v.get(timeout=0.05)
    except asyncio.TimeoutError:
        out.append("timeout")
    await v.set(123)
    out.append(await co.Variable("var1", client=c2).get())
    await v.set(456)  # overwrite
    out.append(await v.get())
    fut = c.submit(constant, "hello", key="var-task")
    await fut.result()
    await v.set(fut)
    got = await co.Variable("var1", client=c2).get()
    out += [got.key, await got.result()]
    await v.delete()
    return out


async def variable_keeps_future_alive(co, cluster, c, c2):
    v = co.Variable("keeper", client=c)
    fut = c.submit(constant, 7, key="kept-task")
    await fut.result()
    await v.set(fut)
    fut.release()
    del fut
    await asyncio.sleep(0.1)
    out = ["kept-task" in cluster.scheduler.state.tasks]
    got = await co.Variable("keeper", client=c2).get()
    out.append(await got.result())
    await v.delete()
    return out


async def pubsub(co, cluster, c, c2):
    sub = co.Sub("topic-1", client=c2)
    await asyncio.sleep(0.05)  # let the subscription register
    pub = co.Pub("topic-1", client=c)
    pub.put({"hello": "world"})
    pub.put([1, 2])
    return [await sub.get(timeout=5), await sub.get(timeout=5)]


async def publish(co, cluster, c, c2):
    fut = c.submit(constant, [1, 2, 3], key="pub-task")
    await fut.result()
    await c.publish_dataset("my-data", fut)
    out = [await c.list_datasets()]
    fut.release()
    await asyncio.sleep(0.05)
    out.append("pub-task" in cluster.scheduler.state.tasks)
    got = await c2.get_dataset("my-data")
    out.append(await got.result())
    try:
        await c2.publish_dataset("my-data", got)
    except Exception as exc:  # noqa: BLE001 - the remote error's type is compared
        out.append(type(exc).__name__)
    await c2.unpublish_dataset("my-data")
    out.append(await c2.list_datasets())
    try:
        await c2.get_dataset("my-data")
    except KeyError as exc:
        out.append(str(exc))
    return out


SCENARIOS = {f.__name__: f for f in (event, lock, multilock, semaphore, queue_data, queue_futures,
                                     queue_future_pending, variable, variable_keeps_future_alive,
                                     pubsub, publish)}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@gen_test(timeout=60)
async def test_coordination_equals_reference(scenario):
    """Two clients on one cluster; every outcome of the scenario equals the
    reference's, in order."""
    out = {}
    for pkg in PACKAGES:
        async with cluster_and_client(pkg, 1) as (cluster, c):
            async with pkg.Client(cluster.scheduler_address) as c2:
                out[pkg.name] = await SCENARIOS[scenario](pkg.coordination, cluster, c, c2)
    assert out["port"] == out["reference"]


@gen_test(timeout=60)
async def test_the_schedulers_carry_the_references_extensions_and_handlers():
    """The port's scheduler and workers register the reference's
    coordination and shuffle extensions under the same keys, and the same
    handler names on each."""
    assert set(default_extensions()) == set(ref_default_extensions())
    assert set(extensions.coordination_extensions()) <= set(default_extensions())
    handlers = {}
    for pkg in PACKAGES:
        async with cluster_and_client(pkg, 1) as (cluster, c):
            s, w = cluster.scheduler, cluster.workers[0]
            handlers[pkg.name] = (
                sorted(k for k in s.handlers if k.split("_")[0] in (
                    "event", "lock", "multi", "semaphore", "queue", "variable", "publish",
                    "shuffle")),
                sorted(k for k in s.stream_handlers if k.startswith("pubsub")),
                sorted(k for k in w.handlers if "shuffle" in k),
                type(w.shuffle).__name__, type(s.extensions["shuffle"]).__name__)
    assert handlers["port"] == handlers["reference"]
    assert "publish_put" in handlers["port"][0] and "device_shuffle_exchange" in handlers["port"][2]
