"""The port's deploy layer (``deploy/spec.py``, ``deploy/local.py``), its
host memory limits (``utils/system.py``), work directories
(``utils/diskutils.py``) and the client's diagnostics
(``diagnostics/progressbar.py``, ``cluster_dump.py``) against the
reference's, on the CPU.

``SpecCluster`` reconciles and scales as the reference's
(``tests/test_deploy.py:31``), ``Adaptive`` scales up from nothing and
back down (``:59``), ``LocalCluster.scale`` retires workers with their
data, and each scenario's outcome equals the reference's.  The device
seam: ``LocalCluster()`` and ``SpecCluster()`` with no device mean the
card and raise without one, ``device="cpu"`` runs here, and an explicit
scheduler option wins.

Task functions live in this module: the port has no cloudpickle.
"""

from __future__ import annotations

import asyncio
import io
import os
import re
import time

import pytest
import torch

from distributed_tpu import config as ref_config
from distributed_tpu.client.client import Client as RefClient
from distributed_tpu.deploy.local import LocalCluster as RefLocalCluster
from distributed_tpu.deploy.spec import Adaptive as RefAdaptive
from distributed_tpu.deploy.spec import SpecCluster as RefSpecCluster
from distributed_tpu.diagnostics import progressbar as ref_progressbar
from distributed_tpu.diagnostics.cluster_dump import DumpArtefact as RefDumpArtefact
from distributed_tpu.scheduler.server import Scheduler as RefScheduler
from distributed_tpu.utils import diskutils as ref_diskutils
from distributed_tpu.utils import objects as ref_objects
from distributed_tpu.utils import system as ref_system
from distributed_tpu.utils.test import StubScheduler as RefStubScheduler
from distributed_tpu.worker.server import Worker as RefWorker
import distributed_tpu_torch
from distributed_tpu_torch import config as port_config
from distributed_tpu_torch import graphs
from distributed_tpu_torch.client.client import Client
from distributed_tpu_torch.deploy import Adaptive, Cluster, LocalCluster, SpecCluster
from distributed_tpu_torch.diagnostics import progressbar
from distributed_tpu_torch.diagnostics.cluster_dump import DumpArtefact
from distributed_tpu_torch.scheduler.server import Scheduler
from distributed_tpu_torch.utils import diskutils, objects, system
from distributed_tpu_torch.utils.test import StubScheduler
from distributed_tpu_torch.worker.server import Worker

from conftest import gen_test

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)


def inc(x):
    return x + 1


def slow_identity(x, delay=0.2):
    time.sleep(delay)
    return x


class Package:
    def __init__(self, name, scheduler, worker, client, spec, adaptive, local, opts):
        self.name, self.Scheduler, self.Worker, self.Client = name, scheduler, worker, client
        self.SpecCluster, self.Adaptive, self.LocalCluster = spec, adaptive, local
        self.scheduler_opts = opts


REF = Package("reference", RefScheduler, RefWorker, RefClient, RefSpecCluster, RefAdaptive,
              RefLocalCluster, {"http_port": None})
PORT = Package("port", Scheduler, Worker, Client, SpecCluster, Adaptive, LocalCluster,
               {"device": "cpu"})
PACKAGES = {"reference": REF, "port": PORT}


def _worker_spec(pkg):
    opts = {"nthreads": 1, "listen_addr": "inproc://"}
    if pkg is REF:
        opts["http_port"] = None
    return {"cls": pkg.Worker, "options": opts}


def _scheduler_spec(pkg, **opts):
    return {"cls": pkg.Scheduler, "options": {"listen_addr": "inproc://",
                                              **pkg.scheduler_opts, **opts}}


async def _until(cond, tries=200, pause=0.02):
    for _ in range(tries):
        if cond():
            return True
        await asyncio.sleep(pause)
    return cond()


async def spec_cluster_reconciles(pkg):
    async with pkg.SpecCluster(
        workers={"a": _worker_spec(pkg), "b": _worker_spec(pkg)},
        scheduler=_scheduler_spec(pkg, validate=True),
        worker=_worker_spec(pkg),
    ) as cluster:
        out = [sorted(cluster.workers)]
        async with pkg.Client(cluster.scheduler_address) as c:
            out.append(await c.gather(c.map(inc, range(8))))
        await cluster.scale(4)
        out.append((sorted(cluster.workers), len(cluster.scheduler.state.workers)))
        await cluster.scale(1)
        out.append(sorted(cluster.workers))
        out.append(await _until(lambda: len(cluster.scheduler.state.workers) == 1))
        return out


async def adaptive_scales_up_and_down(pkg):
    adaptive = pkg.Adaptive(minimum=1, maximum=4, interval=0.05, wait_count=2,
                            target_duration=0.5)
    async with pkg.SpecCluster(
        workers={}, scheduler=_scheduler_spec(pkg), worker=_worker_spec(pkg),
        adaptive=adaptive,
    ) as cluster:
        async with pkg.Client(cluster.scheduler_address) as c:
            futs = c.map(slow_identity, range(8), pure=False)
            grew = await _until(lambda: len(cluster.workers) >= 2, pause=0.05)
            results = await asyncio.wait_for(c.gather(futs), 30)
        shrank = await _until(lambda: len(cluster.workers) <= 1, pause=0.05)
        return grew, results, shrank, any(e[0] == "up" for e in adaptive.log)


async def local_cluster_scales(pkg):
    kw = {"device": "cpu"} if pkg is PORT else {"worker_kwargs": {"http_port": None},
                                                "scheduler_kwargs": {"http_port": None}}
    async with pkg.LocalCluster(n_workers=1, **kw) as cluster:
        async with pkg.Client(cluster.scheduler_address) as c:
            await cluster.scale(4)
            grown = (len(cluster.workers), len(cluster.scheduler.state.workers))
            futs = c.map(inc, range(16), workers=[w.address for w in cluster.workers[2:]])
            await c.gather(futs)
            victims = [w.address for w in cluster.workers[1:]]
            await cluster.scale(1)
            shrunk = (len(cluster.workers), sorted(cluster.scheduler.state.workers))
            # the retired workers' results moved to the one left
            results = await c.gather(futs)
            holders = await c.who_has(futs)
            return (grown, shrunk[0], shrunk[1] == [cluster.workers[0].address], results,
                    {tuple(h) for h in holders.values()} == {(cluster.workers[0].address,)},
                    all(a not in cluster.scheduler.state.workers for a in victims))


SCENARIOS = {f.__name__: f for f in (spec_cluster_reconciles, adaptive_scales_up_and_down,
                                      local_cluster_scales)}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@gen_test(timeout=120)
async def test_the_deploy_layer_gives_the_references_outcome(scenario):
    run = SCENARIOS[scenario]
    ref = await run(REF)
    port = await run(PORT)
    assert port == ref
    if scenario == "spec_cluster_reconciles":
        assert port == [["a", "b"], list(range(1, 9)), (["a", "b", "worker-0", "worker-1"], 4),
                        ["a"], True]
    elif scenario == "adaptive_scales_up_and_down":
        assert port == (True, list(range(8)), True, True)
    else:
        assert port == ((4, 4), 1, True, list(range(1, 17)), True, True)


# ------------------------------------------------------------ the device seam


def test_clusters_default_to_the_card_and_raise_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalCluster(n_workers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        asyncio.run(SpecCluster(workers={})._start())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed_tpu_torch.LocalCluster(n_workers=1, protocol="tcp")


@gen_test(timeout=60)
async def test_an_explicit_scheduler_device_wins(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    async with LocalCluster(n_workers=1, scheduler_kwargs={"device": "cpu"}) as cluster:
        assert str(cluster.scheduler.state.device) == "cpu"
        async with Client(cluster.scheduler_address) as c:
            assert await c.submit(inc, 1).result() == 2
    spec = SpecCluster(workers={}, scheduler={"cls": Scheduler,
                                              "options": {"listen_addr": "inproc://",
                                                          "device": "cpu"}})
    assert spec.scheduler_spec["options"]["device"] == "cpu"
    async with spec:
        assert str(spec.scheduler.state.device) == "cpu"


@gen_test(timeout=60)
async def test_local_cluster_over_tcp_on_the_cpu():
    async with LocalCluster(n_workers=2, threads_per_worker=2, protocol="tcp",
                            device="cpu") as cluster:
        assert cluster.scheduler_address.startswith("tcp://")
        assert all(w.nthreads == 2 for w in cluster.workers)
        async with cluster.get_client() as c:
            assert await c.gather(c.map(inc, range(5))) == [1, 2, 3, 4, 5]
        assert "LocalCluster" in cluster._repr_html_() and "2 workers" in repr(cluster)


def test_the_lazy_exports():
    assert distributed_tpu_torch.LocalCluster is LocalCluster
    assert distributed_tpu_torch.SpecCluster is SpecCluster
    assert distributed_tpu_torch.Cluster is Cluster and distributed_tpu_torch.Adaptive is Adaptive
    assert distributed_tpu_torch.progress is progressbar.progress
    for name in ("Nanny", "Actor", "Client", "Scheduler", "Worker", "WorkerPlugin"):
        assert name in dir(distributed_tpu_torch) and getattr(distributed_tpu_torch, name)
    from distributed_tpu_torch import coordination

    for name in ("Semaphore", "Lock", "MultiLock", "Event", "Queue", "Variable", "Pub", "Sub"):
        assert name in dir(distributed_tpu_torch)
        assert getattr(distributed_tpu_torch, name) is getattr(coordination, name)
    for name in ("SSHCluster", "SubprocessCluster"):
        with pytest.raises(AttributeError):
            getattr(distributed_tpu_torch, name)


# ------------------------------------------------------------ host memory limits


def test_memory_limit_equals_the_references():
    assert system.memory_limit() == ref_system.memory_limit() > 0
    assert system.MEMORY_LIMIT == ref_system.MEMORY_LIMIT
    assert system._cgroup_limit() == ref_system._cgroup_limit()
    assert system._rlimit() == ref_system._rlimit()


@pytest.mark.parametrize("value, nworkers", [
    (None, 1), ("0", 1), (0, 1), (12345, 1), ("4GiB", 1), ("auto", 4), ("auto", 1),
    (0.5, 1), ("0.5", 1), (True, 3), ("100 MB", 1), (1, 1), (2.5e9, 1)])
def test_parse_memory_limit_equals_the_references(value, nworkers):
    assert system.parse_memory_limit(value, nworkers) == \
        ref_system.parse_memory_limit(value, nworkers)


def test_outbound_ip_equals_the_references():
    for addr in ("tcp://127.0.0.1:8786", "127.0.0.1:1", "inproc://x"):
        assert system.outbound_ip(addr) == ref_system.outbound_ip(addr)


# ------------------------------------------------------------ work directories


def test_workspace_purges_dead_owners_as_the_reference(tmp_path):
    for mod, name in ((ref_diskutils, "ref"), (diskutils, "port")):
        base = tmp_path / name
        ws = mod.WorkSpace(str(base))
        live = ws.new_work_dir(prefix="worker")
        dead = ws.new_work_dir(prefix="spill")
        # a pid that cannot be alive: a crash's leftover
        with open(dead._lock_path, "w") as f:
            f.write(str(2**22 + 12345))
        mod.WorkSpace(str(base))
        assert os.path.isdir(live.path) and not os.path.exists(dead.path)
        assert not os.path.exists(dead._lock_path)
        live.release()
        assert os.listdir(base) == []
    assert sorted(os.listdir(tmp_path)) == ["port", "ref"]


@gen_test(timeout=60)
async def test_a_worker_claims_its_local_directory_lazily():
    async with LocalCluster(n_workers=1, device="cpu") as cluster:
        w = cluster.workers[0]
        assert w._local_directory is None
        path = w.local_directory
        assert os.path.isdir(path) and os.path.basename(path).startswith("worker-")
        assert w.local_directory == path


# ------------------------------------------------------------ diagnostics


async def _progress_text(pkg, module):
    async with _cluster(pkg) as (cluster, c):
        futs = c.map(inc, range(6))
        out = io.StringIO()
        await asyncio.wait_for(module.progress(futs, file=out, interval=0.01), 30)
        return re.sub(r"\| *[0-9.]+s", "| s", out.getvalue().split("\r")[-1])


def _cluster(pkg, n_workers=2, threads_per_worker=1):
    if pkg is PORT:
        cluster = LocalCluster(n_workers, threads_per_worker, device="cpu")
    else:
        cluster = RefLocalCluster(n_workers, threads_per_worker,
                                  scheduler_kwargs={"http_port": None},
                                  worker_kwargs={"http_port": None})
    return _Both(cluster, pkg)


class _Both:
    def __init__(self, cluster, pkg):
        self.cluster, self.pkg = cluster, pkg

    async def __aenter__(self):
        await self.cluster._start()
        self.client = self.pkg.Client(self.cluster.scheduler_address)
        await self.client.__aenter__()
        return self.cluster, self.client

    async def __aexit__(self, *exc):
        await self.client.__aexit__(*exc)
        await self.cluster.close()


@gen_test(timeout=60)
async def test_progress_renders_the_references_bar():
    got = await _progress_text(PORT, progressbar)
    assert got == await _progress_text(REF, ref_progressbar)
    assert got == "[" + "#" * 30 + "] 6/6 | s\n"


async def _dump_answers(pkg, artefact, path):
    async with _cluster(pkg) as (cluster, c):
        futs = [c.submit(inc, i, key=f"inc-{i}") for i in range(4)]
        await c.gather(futs)
        await c.dump_cluster_state(str(path))
        d = artefact.from_file(str(path))
        return (d.state_counts(), d.worker_of("inc-0")["state"], len(d.workers),
                sorted(d.tasks_in_state("memory")), len(d.story("inc-1")) > 0,
                sorted(v["has_what"] for v in d.workers_summary().values()),
                d.missing_workers(["tcp://nowhere:1"]), type(d.census_counts()).__name__)


@gen_test(timeout=60)
async def test_a_cluster_dump_reads_as_the_references(tmp_path):
    got = await _dump_answers(PORT, DumpArtefact, tmp_path / "port.json")
    assert got == await _dump_answers(REF, RefDumpArtefact, tmp_path / "ref.json")
    assert got[0] == {"memory": 4} and got[3] == [f"inc-{i}" for i in range(4)]
    # the reference's reader takes the port's dump, and the port's the reference's
    assert RefDumpArtefact.from_file(str(tmp_path / "port.json")).state_counts() == {"memory": 4}
    assert DumpArtefact.from_file(str(tmp_path / "ref.json")).state_counts() == {"memory": 4}


def test_the_typed_payloads_and_the_stub_scheduler_are_the_references():
    for name in ("WorkerInfo", "SchedulerInfo"):
        port, ref = getattr(objects, name), getattr(ref_objects, name)
        assert {k: v.__forward_arg__ for k, v in port.__annotations__.items()} == \
            {k: v.__forward_arg__ for k, v in ref.__annotations__.items()}
        assert port.__total__ is ref.__total__ is False
    port, ref = StubScheduler("state"), RefStubScheduler("state")
    port.send_all({"c": 1}, {"w": 2})
    ref.send_all({"c": 1}, {"w": 2})
    assert vars(port).keys() == vars(ref).keys() and port.sent == ref.sent
    assert port.status.name == ref.status.name == "init"


# ------------------------------------------------------------ BASELINE configs 1 and 3


class _Captured(Exception):
    pass


def test_the_graph_is_the_benchs_config_1_graph(monkeypatch):
    """Keys, order and dependencies of ``graphs.array_sum_graph`` are
    ``bench.py``'s ``cfg_array_sum``'s (caught at its ``compute_graph``)."""
    import bench
    import distributed_tpu.client.client as ref_client_module
    import distributed_tpu.deploy.local as ref_local_module

    class StubCluster:
        scheduler_address = "inproc://nowhere"

        def __init__(self, **kwargs):
            assert kwargs == {"n_workers": 4, "threads_per_worker": 2}

        async def __aenter__(self):
            return self

        async def __aexit__(self, *exc):
            pass

    class StubClient(StubCluster):
        def __init__(self, address):
            pass

        def compute_graph(self, g, outs):
            raise _Captured(g, outs)

    monkeypatch.setattr(ref_local_module, "LocalCluster", StubCluster)
    monkeypatch.setattr(ref_client_module, "Client", StubClient)
    with pytest.raises(_Captured) as info:
        asyncio.run(bench.cfg_array_sum())
    ref, ref_outs = info.value.args
    port, root, blocks = graphs.array_sum_graph()
    assert list(port.tasks) == list(ref.tasks) and [root] == ref_outs
    assert {k: sorted(t.dependencies()) for k, t in port.tasks.items()} == \
        {k: sorted(t.dependencies()) for k, t in ref.tasks.items()}
    assert blocks == [k for k in ref.tasks if k.startswith("ones-")]


async def array_sum(pkg):
    from distributed_tpu.graph.spec import Graph, TaskRef, TaskSpec

    classes = None if pkg is PORT else (Graph, TaskRef, TaskSpec)
    g, root, _ = graphs.array_sum_graph(block=50, classes=classes)
    async with _cluster(pkg, n_workers=4, threads_per_worker=2) as (cluster, c):
        futs = c.compute_graph(g, [root])
        return await futs[root].result()


@gen_test(timeout=60)
async def test_config_1_gives_the_references_sum():
    got = await array_sum(PORT)
    assert got == await array_sum(REF) == float(500 * 500)


STEAL_CONFIG = {"scheduler.jax.enabled": True, "scheduler.jax.periodic-min-workers": 16}


async def imbalanced_slowinc(pkg, steal, n_workers=16, n_tasks=96):
    """``bench.py``'s ``_run_steal`` at 16 workers: tasks pinned to one
    worker with ``allow_other_workers``; with stealing on, the port's steal
    cycles plan on the device path (here its plain version on the CPU)."""
    cfg = ref_config if pkg is REF else port_config
    with cfg.set({"scheduler.work-stealing": steal,
                  **(STEAL_CONFIG if pkg is PORT else {"scheduler.jax.enabled": False})}):
        async with _cluster(pkg, n_workers=n_workers, threads_per_worker=1) as (cluster, c):
            w0 = cluster.workers[0].address
            await c.submit(graphs.slowinc, -1, delay=0.02).result()
            futs = c.map(graphs.slowinc, range(n_tasks), delay=0.02, workers=[w0],
                         allow_other_workers=True)
            results = await c.gather(futs)
            ran_on = {w for ws in (await c.who_has(futs)).values() for w in ws}
            ext = cluster.scheduler.extensions.get("stealing")
            path = getattr(ext, "_device_path", None)
            return results, len(ran_on) > 1, path.counters() if path is not None else None


@pytest.mark.parametrize("steal", [True, False], ids=["steal", "no-steal"])
@gen_test(timeout=120)
async def test_config_3_spreads_as_the_reference(steal):
    results, spread, path = await imbalanced_slowinc(PORT, steal)
    ref_results, ref_spread, _ = await imbalanced_slowinc(REF, steal)
    assert results == ref_results == list(range(96))
    assert spread == ref_spread == steal
    if steal:
        assert path["launches"] > 0 and path["failures"] == 0, path
    else:
        assert path is None
