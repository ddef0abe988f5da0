"""The port's asyncio servers and client (``scheduler/server.py``,
``worker/server.py``, ``client/client.py``) against the reference's, on
the CPU (``Scheduler(device="cpu")``), over inproc and tcp.

Each scenario runs on a reference cluster and on a port cluster, and the
outcomes must be equal: submit, map and gather; a dependency fetched from
another worker; a task error with its traceback; a worker closed with a
result on it, and the result recomputed; ``compute_graph`` of config 2's
tensordot graph (``graphs.tensordot_graph``, ``bench.py``'s
``_tensordot_graph`` with seeded blocks), equal to numpy too.  The
placement plan a 16-worker inproc port cluster makes for that graph
(``TorchPlacement._plan_from_arrays``) equals the plan ``JaxPlacement``
makes for the same graph and join order, with JAX on the CPU.  Then the
shuffle and coordination extensions under the reference's keys, and the
process-group join from a config preload on the port's own worker.  (The
http routes and ``ws://`` are held to the reference's in
``test_torch_http.py`` and ``test_torch_comm_ws.py``.)

Task functions live in this module (or ``operator``): the port has no
cloudpickle, so the standard library's pickle carries them by name.
"""

from __future__ import annotations

import asyncio
import contextlib
import operator
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import bench
from distributed_tpu import config as ref_config
from distributed_tpu.client.client import Client as RefClient
from distributed_tpu.graph.spec import Graph as RefGraph
from distributed_tpu.graph.spec import TaskRef as RefTaskRef
from distributed_tpu.graph.spec import TaskSpec as RefTaskSpec
from distributed_tpu.scheduler.jax_placement import JaxPlacement
from distributed_tpu.scheduler.server import Scheduler as RefScheduler
from distributed_tpu.scheduler.server import default_extensions as ref_default_extensions
from distributed_tpu.worker.server import Worker as RefWorker
from distributed_tpu_torch import config as port_config
from distributed_tpu_torch import graphs
from distributed_tpu_torch.client.client import Client
from distributed_tpu_torch.scheduler.server import Scheduler, default_extensions
from distributed_tpu_torch.scheduler.torch_placement import TorchPlacement
from distributed_tpu_torch.worker.server import Worker

from conftest import gen_test

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
ADDRS = {"inproc": "inproc://", "tcp": "tcp://127.0.0.1:0"}


class Package:
    def __init__(self, name, scheduler, worker, client, config, scheduler_kw, classes):
        self.name, self.Scheduler, self.Worker, self.Client = name, scheduler, worker, client
        self.config, self.scheduler_kw, self.classes = config, scheduler_kw, classes


REF = Package("reference", RefScheduler, RefWorker, RefClient, ref_config,
              {"http_port": None}, (RefGraph, RefTaskRef, RefTaskSpec))
PORT = Package("port", Scheduler, Worker, Client, port_config, {"device": "cpu"}, None)


@contextlib.asynccontextmanager
async def cluster(pkg: Package, addr: str, n: int = 2, **config):
    """A scheduler, ``n`` one-thread workers started one after another (the
    join order) and a client."""
    worker_kw = {"http_port": None} if pkg is REF else {}
    with pkg.config.set(config):
        async with pkg.Scheduler(listen_addr=addr, **pkg.scheduler_kw) as s:
            workers = []
            try:
                for _ in range(n):
                    workers.append(await pkg.Worker(s.address, nthreads=1, **worker_kw).start())
                async with pkg.Client(s.address) as c:
                    yield s, workers, c
            finally:
                for w in workers:
                    await w.close()


def inc(x):
    return x + 1


def boom(x):
    raise ValueError(f"boom {x}")


def pair(a, b):
    return (a, b)


async def submit_map_gather(pkg, addr):
    async with cluster(pkg, addr) as (s, ws, c):
        one = c.submit(operator.add, 1, 2)
        many = c.map(inc, range(10))
        nested = {"a": [one, many[3]], "b": (many[9], 7)}
        kw = c.submit(pair, 1, b=np.arange(3))
        return (await one.result(), await c.gather(many), await c.gather(nested),
                await kw.result())


async def dependency_from_another_worker(pkg, addr):
    async with cluster(pkg, addr) as (s, (a, b), c):
        x = c.submit(np.arange, 8, workers=[a.address])
        y = c.submit(operator.mul, x, 3, workers=[b.address])
        out = await y.result()
        holders = (await c.who_has([x]))[x.key]
        # b fetched x from a to run y: it holds a replica now
        assert x.key in b.state.tasks
        return out, sorted([a.address, b.address].index(h) for h in holders)


async def task_error(pkg, addr):
    async with cluster(pkg, addr) as (s, ws, c):
        bad = c.submit(boom, 3)
        child = c.submit(inc, bad)
        exc = await bad.exception()
        tb = "".join(__import__("traceback").format_tb(await bad.traceback()))
        with pytest.raises(ValueError, match="boom 3"):
            await child.result()
        return type(exc), exc.args, "boom" in tb, bad.status, child.status


async def worker_closed_mid_graph(pkg, addr):
    async with cluster(pkg, addr, n=3) as (s, (a, b, z), c):
        x = c.submit(inc, 1, workers=[a.address], allow_other_workers=True)
        assert await x.result() == 2
        await a.close()
        while a.address in s.state.workers:
            await asyncio.sleep(0.01)
        y = c.submit(inc, x)
        ys = c.map(inc, [y] * 4, pure=False)
        return await y.result(), await c.gather(ys), x.status


async def tensordot(pkg, addr):
    async with cluster(pkg, addr, n=4) as (s, ws, c):
        g, outs = graphs.tensordot_graph(4, classes=pkg.classes)
        futs = c.compute_graph(g, outs)
        res = await c.gather([futs[k] for k in outs])
        return np.stack([np.asarray(r) for r in res]).reshape(4, 4, 4, 4)


SCENARIOS = {f.__name__: f for f in (submit_map_gather, dependency_from_another_worker,
                                      task_error, worker_closed_mid_graph, tensordot)}


def same(a, b) -> bool:
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return type(b) is dict and list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("transport", sorted(ADDRS))
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@gen_test(timeout=120)
async def test_the_port_gives_the_references_outcome(scenario, transport):
    run = SCENARIOS[scenario]
    ref = await run(REF, ADDRS[transport])
    port = await run(PORT, ADDRS[transport])
    assert same(port, ref), (ref, port)
    if scenario == "tensordot":
        assert np.array_equal(port, graphs.tensordot_expected(4))


def test_the_graph_is_the_benchs_config_2_graph():
    """Keys, order and dependencies of ``graphs.tensordot_graph`` are
    ``bench.py``'s ``_tensordot_graph``'s."""
    ref, ref_outs = bench._tensordot_graph(4, tag="w")
    port, port_outs = graphs.tensordot_graph(4, tag="w")
    assert list(port.tasks) == list(ref.tasks) and port_outs == ref_outs
    assert {k: sorted(t.dependencies()) for k, t in port.tasks.items()} == \
        {k: sorted(t.dependencies()) for k, t in ref.tasks.items()}
    assert len(graphs.tensordot_graph(32)[0].tasks) == len(bench._tensordot_graph(32)[0].tasks)


PLAN_CONFIG = {"scheduler.jax.enabled": True, "scheduler.jax.min-workers": 0,
               "scheduler.jax.min-transfer-ratio": 0}


async def _captured_plan(pkg, placement_cls, monkeypatch):
    calls = []
    plan = placement_cls._plan_from_arrays

    def spy(self, keys, durations, out_bytes, src, dst, nthreads, occupancy, running, addrs,
            *args, **kwargs):
        hints = plan(self, keys, durations, out_bytes, src, dst, nthreads, occupancy, running,
                     addrs, *args, **kwargs)
        calls.append(((list(keys), *(np.array(a) for a in (durations, out_bytes, src, dst,
                                                          nthreads, occupancy, running))),
                      list(addrs), args, hints))
        return hints

    monkeypatch.setattr(placement_cls, "_plan_from_arrays", spy)
    async with cluster(pkg, "inproc://", n=16, **PLAN_CONFIG) as (s, ws, c):
        assert type(s.state.placement) is placement_cls
        g, outs = graphs.tensordot_graph(8, classes=pkg.classes)
        futs = c.compute_graph(g, outs)
        await c.gather([futs[k] for k in outs])
        joined = [w.address for w in ws]
    assert calls, f"{pkg.name}: no plan"
    arrays, addrs, args, hints = calls[0]
    if isinstance(hints, tuple):  # the reference's (plan, engine_shards)
        hints, shards = hints
        assert shards is None  # the partitioner's branch
    index = {a: joined.index(a) for a in addrs}
    return (arrays, [index[a] for a in addrs], args,
            {k: (follow, index[a]) for k, (follow, a) in hints.items()})


@gen_test(timeout=180)
async def test_the_16_worker_plan_equals_jax_placements(monkeypatch):
    ref = await _captured_plan(REF, JaxPlacement, monkeypatch)
    port = await _captured_plan(PORT, TorchPlacement, monkeypatch)
    (ref_arrays, ref_addrs, ref_args, ref_hints), (arrays, addrs, args, hints) = ref, port
    assert arrays[0] == ref_arrays[0]  # the batch's keys, in order
    for got, want in zip(arrays[1:], ref_arrays[1:]):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert addrs == ref_addrs == list(range(16)) and args == ref_args
    assert len(hints) == len(ref_hints) > 500
    assert hints == ref_hints


# ------------------------------------------------------------ extensions


@gen_test(timeout=60)
async def test_shuffle_and_coordination_are_the_references():
    """The port's scheduler has the reference's extension keys, its worker
    the port's own ``ShuffleWorkerExtension``, and both serve the
    reference's shuffle and coordination handlers, over tcp as the
    reference's do."""
    from distributed_tpu_torch.shuffle.core import ShuffleWorkerExtension

    assert set(default_extensions()) == set(ref_default_extensions())
    assert {"shuffle", "events", "locks", "publish", "pubsub"} <= set(default_extensions())
    out = {}
    for pkg in (REF, PORT):
        async with cluster(pkg, "tcp://127.0.0.1:0") as (s, (a, b), c):
            ops = ("shuffle_get_or_create", "shuffle_get_run", "shuffle_restart", "shuffle_barrier",
                   "event_set", "lock_acquire", "multi_lock_acquire", "semaphore_acquire",
                   "queue_put", "variable_set", "publish_put", "publish_list")
            worker_ops = ("shuffle_receive", "shuffle_receive_flush", "shuffle_wait_pushes",
                          "shuffle_inputs_done", "shuffle_fetch_output",
                          "device_shuffle_exchange", "device_shuffle_precheck")
            out[pkg.name] = (
                [op in s.handlers for op in ops],
                [op in s.stream_handlers for op in ("pubsub-msg", "pubsub-add-subscriber")],
                [op in a.handlers for op in worker_ops],
                type(a.shuffle).__name__,
                await c.scheduler.shuffle_barrier(id="x", run_id=0),
                await c.scheduler.publish_list())
            if pkg is PORT:
                assert isinstance(a.shuffle, ShuffleWorkerExtension) and a.shuffle.worker is a
    assert out["port"] == out["reference"]
    assert all(out["port"][0]) and all(out["port"][1]) and all(out["port"][2])
    assert out["port"][4] == {"status": "unknown-shuffle", "id": "x"}


def readme_port_preload() -> str:
    """The README's preload for a port cluster, with the device set to the CPU."""
    blocks = re.findall(r"```python\n(.*?)```", (ROOT / "README.md").read_text(), re.S)
    (source,) = [b for b in blocks if "hold_process_group" in b and "dtpu_setup" in b]
    assert source.count("DEVICE = None") == 1
    return source.replace("DEVICE = None", 'DEVICE = "cpu"')


@gen_test(timeout=60)
async def test_a_config_preload_joins_the_group_on_the_ports_worker(monkeypatch):
    from test_torch_worker_join import _free_port

    for name, value in {"MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()),
                        "RANK": "0", "WORLD_SIZE": "1"}.items():
        monkeypatch.setenv(name, value)
    assert not dist.is_initialized()
    with port_config.set({"worker.preload": [readme_port_preload()]}):
        async with Scheduler(listen_addr="inproc://", device="cpu") as s:
            async with Worker(s.address, nthreads=1) as w:
                assert s.state.workers[w.address].extra["jax_devices"] == [0]
                assert dist.is_initialized() and dist.get_backend() == "gloo"
                await w.close()
                assert not dist.is_initialized()
