"""The port's http server (``http/server.py``), its dashboard
(``http/dashboard.py``) and the servers' route tables against the
reference's, on the CPU.

- The Prometheus line builders are byte-identical to the reference's on
  the same inputs (the same objects handed to both).
- On stand-in scheduler and worker roles driven identically in each
  package (the reference's ``test_metrics_names_unique_and_documented``),
  every ``dtpu_*`` sample is unique, every name is in
  ``docs/observability.md``, and the name sets equal the reference's.
- On a live two-worker cluster of each package doing the same work: the
  ``/`` route index of each role, the ``/metrics`` name sets, the
  deterministic gauges (tasks by state, workers, clients), the JSON API's
  keys and counts and the ``/dashboard`` page equal the reference's.
  ``dtpu_build_info`` is the one allowed difference: its labels name
  torch, CUDA and the card where the reference's name jax.
- ``/ledger`` joins every placement of a flood to its memory outcome,
  waited for with a deadline (the reference's live test reads it once).

Task functions live in this module: the port has no cloudpickle.
"""

from __future__ import annotations

import asyncio
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_tpu import config as ref_config
from distributed_tpu.client.client import Client as RefClient
from distributed_tpu.deploy.local import LocalCluster as RefLocalCluster
from distributed_tpu.http import server as ref_http
from distributed_tpu.http import dashboard as ref_dashboard
from distributed_tpu.protocol import buffers as ref_buffers
from distributed_tpu_torch import config
from distributed_tpu_torch.client.client import Client
from distributed_tpu_torch.deploy.local import LocalCluster
from distributed_tpu_torch.http import dashboard
from distributed_tpu_torch.http import server as http
from distributed_tpu_torch.protocol import buffers
from distributed_tpu_torch.tracing import Histogram, from_jsonl
from torch_ref_native import ref_native_lib  # noqa: F401 (autouse: the reference's native library)

from conftest import gen_test

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
BUILD_INFO_LABELS = ["role", "version", "torch", "cuda", "backend", "device", "mesh"]
REF_BUILD_INFO_LABELS = ["role", "version", "jax", "backend", "mesh"]


def inc(x):
    return x + 1


def double(x):
    return 2 * x


# ------------------------------------------------------------ stand-in roles


def _stand_ins(port: bool):
    """The reference's stand-in scheduler and worker of
    ``test_metrics_names_unique_and_documented``, built from one package's
    classes and driven the same way."""
    if port:
        from distributed_tpu_torch.diagnostics.census import RetentionSentinel
        from distributed_tpu_torch.diagnostics.selfprofile import ControlPlaneProfiler, LoopWatchdog
        from distributed_tpu_torch.ops.partition import make_engine_mesh
        from distributed_tpu_torch.scheduler.durability import DurabilityManager, MemorySink
        from distributed_tpu_torch.scheduler.state import SchedulerState
        from distributed_tpu_torch.telemetry import LinkTelemetry
        from distributed_tpu_torch.worker.state_machine import WorkerState

        state = SchedulerState(device="cpu")
        mesh = make_engine_mesh(layout="4x2", devices=["cpu"] * 8)
    else:
        from distributed_tpu.diagnostics.census import RetentionSentinel
        from distributed_tpu.diagnostics.selfprofile import ControlPlaneProfiler, LoopWatchdog
        from distributed_tpu.ops.partition import make_engine_mesh
        from distributed_tpu.scheduler.durability import DurabilityManager, MemorySink
        from distributed_tpu.scheduler.state import SchedulerState
        from distributed_tpu.telemetry import LinkTelemetry
        from distributed_tpu.worker.state_machine import WorkerState

        state = SchedulerState()
        mesh = make_engine_mesh(layout="4x2")

    class Stealing:
        count = 3

    class Sched:
        extensions = {"stealing": Stealing()}
        cp_profiler = ControlPlaneProfiler(idents=lambda: [])
        watchdog = LoopWatchdog()

    Sched.state = state
    Sched.watchdog.tick()
    with state.wall.phase("engine.drain", "pm-stim"):
        pass
    state.new_task("metrics-k", None)
    tel = state.telemetry
    tel.fold_rows([["tcp://pm:1", "tcp://pm:2", 1_000_000, 0.01, 2]], reporter="tcp://pm:2")
    tel.fold_rows([["tcp://pm:1", "tcp://pm:2", 1_100_000, 0.01, 2]], reporter="tcp://pm:1")
    tel.record_rtt("tcp://pm:2", 0.002)
    tel.fold_fine_rows([
        ["execute", "", "inc", "compute", "seconds", 0.5],
        ["execute", "", "inc", "output", "bytes", 1000.0],
        ["execute", "", "inc", "count", "tasks", 2],
    ])
    tel.observe_divergence(1.0, 0.1, True)
    led = state.ledger
    h = led.file("placement", "pm-led-k", "inc", "tcp://pm:2", "pm-stim",
                 0.01, 0.02, True, 4096, 1, 0.5, "tcp://pm:1", "")
    led.join_row(h, "memory", "tcp://pm:2", None, 0.4, tel)
    led.file("steal", "pm-led-open", "inc", "tcp://pm:2", "pm-stim2")
    state.add_worker_state("tcp://pm:9", nthreads=1, memory_limit=2**30, name="pm9")
    state.mirror.sharded_device_view(mesh)
    state.observe_engine_shards([{"shard": 0, "kernel_ms": 0.5, "h2d_bytes": 1024},
                                 {"shard": 1, "kernel_ms": 0.6, "h2d_bytes": 1024}])
    state.attach_native(build=True)
    Sched.durability = DurabilityManager(state, MemorySink())
    Sched.durability.snapshot(full=True)
    state.census.sentinel = RetentionSentinel(state.census, trace=state.trace)
    state.census.sentinel.tick()

    class SpillDict(dict):
        spilled_count = 0
        slow_bytes = 0

    class Work:
        state = WorkerState(nthreads=1)
        data = SpillDict()
        get_data_wire_bytes = 0
        telemetry = LinkTelemetry()
        cp_profiler = ControlPlaneProfiler(idents=lambda: [])
        watchdog = LoopWatchdog()

    Work.telemetry.record("tcp://pm:2", "tcp://pm:3", 1000, 0.001)
    with Work.state.wall.phase("wengine.stimulus", "pm-stim"):
        pass
    Work.state.census.sentinel = RetentionSentinel(Work.state.census, trace=Work.state.trace)
    Work.state.census.sentinel.tick()
    return Sched(), Work()


def _names(blob: bytes) -> set[str]:
    """The ``dtpu_*`` names of an exposition; every sample and TYPE once."""
    seen, declared, names = set(), set(), set()
    for line in blob.decode().splitlines():
        if not line:
            continue
        if line.startswith("# TYPE "):
            name = line.split()[2]
            assert name not in declared, f"duplicate TYPE for {name}"
            declared.add(name)
            continue
        if line.startswith("#"):
            continue
        sample = line.rsplit(" ", 1)[0]
        name = sample.split("{", 1)[0]
        assert name.startswith("dtpu_"), line
        assert sample not in seen, f"duplicate sample {sample}"
        seen.add(sample)
        names.add(name)
    return names


def _build_info(blob: bytes) -> dict:
    (line,) = [ln for ln in blob.decode().splitlines() if ln.startswith("dtpu_build_info{")]
    assert line.endswith("} 1")
    body = line[len("dtpu_build_info{"):-len("} 1")]
    return dict(kv.split("=", 1) for kv in body.split(","))


@pytest.fixture(scope="module")
def stand_ins():
    return {"port": _stand_ins(True), "reference": _stand_ins(False)}


def test_metric_names_are_unique_documented_and_the_references(stand_ins):
    """The port's twin of ``test_metrics_names_unique_and_documented``: the
    same families on both roles, each documented; the reference's names."""
    docs = (ROOT / "docs/observability.md").read_text()
    sched, work = stand_ins["port"]
    ref_sched, ref_work = stand_ins["reference"]
    port_s, port_w = _names(http.scheduler_metrics(sched)), _names(http.worker_metrics(work))
    ref_s = _names(ref_http.scheduler_metrics(ref_sched))
    ref_w = _names(ref_http.worker_metrics(ref_work))
    assert port_s == ref_s and port_w == ref_w
    assert not sorted(n for n in port_s | port_w if n not in docs)
    assert {"dtpu_build_info", "dtpu_scheduler_tasks", "dtpu_durability_epochs_total",
            "dtpu_mirror_shard_rows_uploaded_total", "dtpu_engine_shard_kernel_ms",
            "dtpu_ledger_regret_seconds_bucket", "dtpu_census_count", "dtpu_loop_lag_seconds_bucket",
            "dtpu_link_heartbeat_rtt_seconds", "dtpu_worker_spill_count_total",
            "dtpu_wire_pool_bytes"} <= port_s | port_w
    if sched.state.native is not None:
        assert "dtpu_engine_native_transitions_total" in port_s
    # the one difference: dtpu_build_info's labels
    for role, blob, ref_blob in (
            ("scheduler", http.scheduler_metrics(sched), ref_http.scheduler_metrics(ref_sched)),
            ("worker", http.worker_metrics(work), ref_http.worker_metrics(ref_work))):
        labels, ref_labels = _build_info(blob), _build_info(ref_blob)
        assert list(labels) == BUILD_INFO_LABELS and list(ref_labels) == REF_BUILD_INFO_LABELS
        assert labels["role"] == ref_labels["role"] == f'"{role}"'
        assert labels["backend"] == labels["device"] == '"cpu"'
        assert labels["torch"] == f'"{torch.__version__}"' and labels["mesh"] == ref_labels["mesh"]


# ------------------------------------------------------------ line builders


def _hist(seed, bounds=(0.001, 0.01, 0.1, 1.0, 10.0)):
    h = Histogram(list(bounds))
    for v in np.random.default_rng(seed).exponential(0.2, 200):
        h.observe(float(v))
    return h


PROM_CASES = [
    ("dtpu_x", 1, None, None, "gauge"),
    ("dtpu_x", 2.5, {"a": "b"}, None, "gauge"),
    ("dtpu_x_total", 7, {"src": "tcp://h:1", "dst": "tcp://h:2"}, "help text", "counter"),
    ("dtpu_y", 0.1 + 0.2, None, "one", "gauge"),
]


@pytest.mark.parametrize("case", range(len(PROM_CASES)))
def test_prom_line_is_the_references(case):
    name, value, labels, help_, type_ = PROM_CASES[case]
    assert http.prom_line(name, value, labels, help_, type_) == ref_http.prom_line(
        name, value, labels, help_, type_)


@pytest.mark.parametrize("labels", [None, {"kind": "placement", "model": "measured"}])
@pytest.mark.parametrize("help_", [None, "per decision"])
def test_prom_histogram_lines_are_the_references(labels, help_):
    h = _hist(3, bounds=(0.5, 1, 2.5, 10))
    assert http.prom_histogram_lines("dtpu_h", h, help_=help_, labels=labels) == \
        ref_http.prom_histogram_lines("dtpu_h", h, help_=help_, labels=labels)


FAMILIES = {
    "trace": lambda m, s, w: m.trace_metric_lines(s.state.trace),
    "selfprofile": lambda m, s, w: m.selfprofile_metric_lines(s.state.wall, s.cp_profiler,
                                                              s.watchdog),
    "selfprofile_worker": lambda m, s, w: m.selfprofile_metric_lines(w.state.wall, None, None),
    "census": lambda m, s, w: m.census_metric_lines(s.state.census),
    "census_worker": lambda m, s, w: m.census_metric_lines(w.state.census),
    "ledger": lambda m, s, w: m.ledger_metric_lines(s.state.ledger),
    "telemetry": lambda m, s, w: m.telemetry_metric_lines(w.telemetry),
    "cluster_telemetry": lambda m, s, w: m.cluster_telemetry_metric_lines(s.state.telemetry),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_line_families_are_the_references(family, stand_ins):
    """Each family builder, given the port's driven objects, writes the
    reference's lines byte for byte."""
    sched, work = stand_ins["port"]
    lines = FAMILIES[family](http, sched, work)
    assert lines and lines == FAMILIES[family](ref_http, sched, work)


def test_wire_lines_are_the_references(monkeypatch):
    class Wire:
        pass

    wire = Wire()
    for i, name in enumerate(("bytes_sent", "bytes_recv", "payload_copies", "pool_hits",
                              "pool_misses", "pool_drops", "compress_bytes_in",
                              "compress_bytes_out", "decompress_bytes_in")):
        setattr(wire, name, 1000 * i + 7)
    pool = type("Pool", (), {"pooled_bytes": 4096})()
    for mod in (buffers, ref_buffers):
        monkeypatch.setattr(mod, "WIRE", wire)
        monkeypatch.setattr(mod, "recv_pool", lambda: pool)
    assert http.wire_metric_lines() == ref_http.wire_metric_lines()
    assert "\ndtpu_wire_pool_bytes 4096" in "\n".join(http.wire_metric_lines())


def test_the_dashboard_page_is_the_references():
    assert dashboard.DASHBOARD_HTML == ref_dashboard.DASHBOARD_HTML


# ------------------------------------------------------------ live clusters


async def http_get(port: int, path: str) -> tuple[int, str, bytes]:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.0\r\n\r\n".encode())
    await writer.drain()
    data = await reader.read()
    writer.close()
    head, _, body = data.partition(b"\r\n\r\n")
    lines = head.decode().split("\r\n")
    ctype = [ln.split(":", 1)[1].strip() for ln in lines if ln.startswith("Content-Type")]
    return int(lines[0].split()[1]), ctype[0] if ctype else "", body


async def _until(cond, seconds=60.0, pause=0.05):
    deadline = time.monotonic() + seconds
    while not cond():
        if time.monotonic() > deadline:
            return False
        await asyncio.sleep(pause)
    return True


def _gauges(text: str) -> dict:
    keep = ("dtpu_scheduler_tasks", "dtpu_scheduler_workers", "dtpu_scheduler_clients")
    return {ln.rsplit(" ", 1)[0]: ln.rsplit(" ", 1)[1] for ln in text.splitlines()
            if ln.split("{")[0].split(" ")[0] in keep}


def _shape(obj):
    """Keys and counts of a JSON value, without its measured numbers (or
    the workers' addresses where they are keys)."""
    if isinstance(obj, dict) and any("://" in k for k in obj):
        return sorted((_shape(v) for v in obj.values()), key=repr)
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in sorted(obj.items())}
    if isinstance(obj, list):
        return [_shape(v) for v in obj]
    return type(obj).__name__


#: no periodic sample of the system monitors while a live cluster is read
MONITOR_BY_HAND = {"admin.system-monitor.interval": "1h"}


async def _live(port: bool) -> dict:
    """A two-worker cluster of one package maps 20 tasks; then every route
    of both roles is read.  (Not ``validate=True``: a validating scheduler
    attaches no native engine.)"""
    with (config if port else ref_config).set(MONITOR_BY_HAND):
        return await _live_routes(port)


async def _live_routes(port: bool) -> dict:
    if port:
        cluster, client_cls = LocalCluster(n_workers=2, device="cpu"), Client
    else:
        cluster, client_cls = RefLocalCluster(n_workers=2), RefClient
    out: dict = {}
    async with cluster:
        s = cluster.scheduler
        async with client_cls(cluster.scheduler_address) as c:
            futs = c.map(double, range(20), pure=False)
            out["results"] = await c.gather(futs)
            # the native engine attaches when its build lands; wait for it in
            # both packages so both expositions carry its families
            assert await _until(lambda: s.state.native is not None)
            # every monitor's first sample, and no other: /api/v1/memory holds
            # the scheduler's series, one entry a sample, and a cluster that
            # lived past the 500 ms interval in one package only had one
            # sample more there
            for monitor in (s.monitor, *(w.monitor for w in cluster.workers)):
                assert monitor.count == 0
                monitor.update()
            for w in cluster.workers:
                await w.heartbeat()
            sport = s.http_server.port
            wport = cluster.workers[0].http_server.port
            wname = str(cluster.workers[0].name)
            for role, p in (("scheduler", sport), ("worker", wport)):
                status, ctype, body = await http_get(p, "/")
                idx = json.loads(body)
                out[f"{role} index"] = (status, ctype, idx["role"], idx["routes"])
                status, ctype, body = await http_get(p, "/metrics")
                out[f"{role} metrics"] = (status, ctype, _names(body))
                out[f"{role} build_info"] = _build_info(body)
                if role == "scheduler":
                    out["gauges"] = _gauges(body.decode())
                status, ctype, body = await http_get(p, "/health")
                out[f"{role} health"] = (status, ctype, body)
                out[f"{role} 404"] = (await http_get(p, "/nope"))[0]
            for path in ("/info", "/json/counts.json", "/api/v1/workers", "/api/v1/memory",
                         "/api/v1/graph", "/workers", f"/workers/{wname}/info",
                         f"/workers/{wname}/metrics", f"/workers/{wname}/health"):
                status, ctype, body = await http_get(sport, path)
                out[path.replace(wname, "<w>")] = (status, ctype, _shape(json.loads(body)))
            status, ctype, body = await http_get(sport, "/api/v1/tasks")
            out["/api/v1/tasks"] = (status, ctype, json.loads(body))
            status, ctype, body = await http_get(sport, "/workers/nobody/info")
            out["/workers/nobody"] = (status, ctype, json.loads(body))
            status, ctype, body = await http_get(sport, "/dashboard")
            out["/dashboard"] = (status, ctype, body)
    return out


@gen_test(timeout=120)
async def test_a_live_cluster_serves_the_references_routes():
    ref = await _live(False)
    ours = await _live(True)
    assert ours["results"] == ref["results"] == [2 * i for i in range(20)]
    ours_bi, ref_bi = ours.pop("scheduler build_info"), ref.pop("scheduler build_info")
    wbi, ref_wbi = ours.pop("worker build_info"), ref.pop("worker build_info")
    assert list(ours_bi) == list(wbi) == BUILD_INFO_LABELS
    assert list(ref_bi) == list(ref_wbi) == REF_BUILD_INFO_LABELS
    assert ours_bi["backend"] == ours_bi["device"] == wbi["backend"] == '"cpu"'
    assert ours_bi["role"] == '"scheduler"' and wbi["role"] == '"worker"'
    assert set(ours) == set(ref)
    for key in sorted(ours):
        assert ours[key] == ref[key], key
    assert ours["scheduler index"][2] == "scheduler" and "/ledger" in ours["scheduler index"][3]
    assert ours["worker index"][2] == "worker" and "/ledger" not in ours["worker index"][3]
    assert ours["gauges"]["dtpu_scheduler_workers"] == "2"
    assert ours["/api/v1/tasks"][2]["by_state"] == {"memory": 20}
    assert ours["/dashboard"][1] == "text/html; charset=utf-8"


@gen_test(timeout=120)
async def test_route_index_ledger_and_build_info_live():
    """The port's twin of the reference's live test of the same name, with
    ``/ledger`` read until its memory outcomes reach 8 or a deadline passes
    (the outcome of the last tasks of a flood can land after the gather)."""
    async with LocalCluster(n_workers=2, device="cpu", scheduler_kwargs={"validate": True},
                            worker_kwargs={"validate": True}) as cluster:
        async with Client(cluster.scheduler_address) as c:
            await c.gather(c.map(inc, range(8), pure=False))
            sport = cluster.scheduler.http_server.port
            wport = cluster.workers[0].http_server.port
            idx = json.loads((await http_get(sport, "/"))[2])
            assert idx["role"] == "scheduler"
            assert {"/metrics", "/trace", "/telemetry", "/profile", "/ledger"} <= set(idx["routes"])
            widx = json.loads((await http_get(wport, "/"))[2])
            assert widx["role"] == "worker"
            assert {"/metrics", "/trace", "/telemetry", "/profile"} <= set(widx["routes"])

            deadline = time.monotonic() + 30
            while True:
                status, ctype, body = await http_get(sport, "/ledger")
                recs = from_jsonl(body)
                if recs[0]["outcomes"].get("memory", 0) >= 8 or time.monotonic() > deadline:
                    break
                await asyncio.sleep(0.05)
            assert status == 200 and ctype == "application/x-ndjson"
            assert recs[0]["type"] == "ledger-summary"
            assert recs[0]["outcomes"].get("memory", 0) >= 8
            rows = [r for r in recs if r["type"] == "ledger-row"]
            assert rows and all(r["v"] == 1 for r in rows)
            rpc = await c.scheduler.get_ledger(n=4)
            assert rpc[0]["type"] == "ledger-summary" and len(rpc) == 5
            for port, role in ((sport, "scheduler"), (wport, "worker")):
                labels = _build_info((await http_get(port, "/metrics"))[2])
                assert labels["role"] == f'"{role}"' and labels["backend"] == '"cpu"'
            text = (await http_get(sport, "/metrics"))[2].decode()
            assert "dtpu_ledger_rows_total" in text and "dtpu_ledger_joined_total" in text
            for path in ("/trace", "/telemetry", "/census", "/profile"):
                status, ctype, body = await http_get(sport, path)
                assert status == 200 and ctype == "application/x-ndjson" and from_jsonl(body)
