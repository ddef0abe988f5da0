"""The port's host periphery against the reference: ``utils/sizeof.py``,
``protocol/serialize.py``, ``diagnostics/device_profile.py``,
``http/build_info.py`` and the entry twin ``entry.py``.

Tolerance: none.  Sizes, headers and frame bytes are equal to the
reference's; the entry twin's four outputs equal ``__graft_entry__.entry()``
bit for bit (the plain wave reproduces ``_place_run`` expression for
expression on the CPU).

Every installer writes into a process-wide object of the reference that
later tests in the same process read (the suite runs many files a
process).  So each install here is undone in its fixture's teardown, which
asserts that the reference's own objects are back, and one test per
installer checks the counted install and its restoration by identity.
"""

from __future__ import annotations

import asyncio
import contextlib
import importlib
import importlib.util
import json
import os
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tpu import config as dtpu_config
from distributed_tpu.client.client import Client
from distributed_tpu.deploy.local import LocalCluster
from distributed_tpu.diagnostics import device_profile as ref_profile
from distributed_tpu.http import server as http_server
from distributed_tpu_torch import __version__
from distributed_tpu_torch._install import install_count
from distributed_tpu_torch.diagnostics import device_profile
from distributed_tpu_torch.entry import dryrun_multichip, entry
from distributed_tpu_torch.http.build_info import build_info_lines, install_build_info
from distributed_tpu_torch.protocol.serialize import (
    install_serialization,
    torch_dumps,
    torch_loads,
)
from distributed_tpu_torch.utils.sizeof import install_sizeof, tensor_sizeof

import chip_smoke
from conftest import gen_test

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
# the modules: their packages re-export a function of the same name
SIZEOF_MOD = importlib.import_module("distributed_tpu.utils.sizeof")
ref_ser = importlib.import_module("distributed_tpu.protocol.serialize")
sizeof = SIZEOF_MOD.sizeof
PROFILE_FUNCTIONS = device_profile.FUNCTIONS


# ------------------------------------------------------------ sizeof


@pytest.fixture
def sized():
    """``install_sizeof`` on the reference's ``sizeof``, taken out after."""
    before = dict(SIZEOF_MOD._sizeof_dispatch.registry)
    handle = install_sizeof(sizeof)
    yield handle
    handle.uninstall()
    after = SIZEOF_MOD._sizeof_dispatch.registry
    assert set(after) == set(before) and all(after[k] is v for k, v in before.items())
    assert torch.Tensor not in SIZEOF_MOD._exact


SIZE_DTYPES = {
    "int32": (np.int32, torch.int32, jnp.int32),
    "int64": (np.int64, torch.int64, jnp.int64),
    "float16": (np.float16, torch.float16, jnp.float16),
    "bfloat16": (np.float32, torch.bfloat16, jnp.bfloat16),
    "float32": (np.float32, torch.float32, jnp.float32),
    "bool": (bool, torch.bool, jnp.bool_),
}
SIZE_SHAPES = [(), (0,), (1,), (3, 5), (257, 3)]  # the 64 B floor, then above it


def _pair(dtype: str, shape, seed: int = 0):
    np_dt, t_dt, j_dt = SIZE_DTYPES[dtype]
    a = (np.random.default_rng(seed).standard_normal(shape) * 100).astype(np_dt)
    with jax.enable_x64(dtype == "int64"):  # without x64 jax keeps int64 as int32
        j = jnp.asarray(a).astype(j_dt)
    assert j.dtype.itemsize == np.dtype(np_dt).itemsize or dtype == "bfloat16"
    return torch.from_numpy(np.array(a)).to(t_dt), j


@pytest.mark.parametrize("shape", SIZE_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", sorted(SIZE_DTYPES))
def test_tensor_sizes_as_the_same_jax_array(sized, dtype, shape):
    t, j = _pair(dtype, shape)
    assert sizeof(t) == sizeof(j) == tensor_sizeof(t)
    assert sizeof(t) == max(int(np.prod(shape, dtype=np.int64)) * t.element_size(), 64)


def test_strided_view_counts_its_elements(sized):
    t = torch.zeros(64, 32)
    view = t[:, ::2]
    assert sizeof(view) == sizeof(jnp.zeros((64, 16), jnp.float32)) == 64 * 16 * 4


def test_device_shuffle_output_sizes_as_the_jax_arrays(sized):
    """ROADMAP queue 3's input: the device shuffle's output of 2^20 rows."""
    n = 2 ** 20
    as_torch = (torch.zeros(n, dtype=torch.int32), torch.zeros(n, 4))
    as_jax = (jnp.zeros(n, jnp.int32), jnp.zeros((n, 4), jnp.float32))
    assert sizeof(as_torch) == sizeof(as_jax) == 20_971_576
    assert sizeof(torch.zeros(n, 4)) == 16_777_216


def test_install_sizeof_counts_and_restores_the_dispatch():
    t = torch.zeros(2 ** 20, 4)
    assert sizeof(t) == 72  # sys.getsizeof: the fault the install fixes
    registry = SIZEOF_MOD._sizeof_dispatch.registry
    before = dict(registry)
    first, second = install_sizeof(sizeof), install_sizeof(sizeof)
    try:
        assert install_count("sizeof", sizeof) == 2
        assert registry[torch.Tensor] is tensor_sizeof
        assert sizeof(t) == 16_777_216
        first.uninstall()
        first.uninstall()  # a second call of one handle gives nothing back
        assert install_count("sizeof", sizeof) == 1 and sizeof(t) == 16_777_216
    finally:
        second.uninstall()
    assert install_count("sizeof", sizeof) == 0
    assert torch.Tensor not in registry
    assert set(registry) == set(before) and all(registry[k] is v for k, v in before.items())
    assert torch.Tensor not in SIZEOF_MOD._exact
    assert sizeof(t) == 72


# ------------------------------------------------------------ the wire


@pytest.fixture
def wire():
    original = ref_ser.families["torch"]
    handle = install_serialization(ref_ser.register_serialization_family, ref_ser.families)
    yield handle
    handle.uninstall()
    assert ref_ser.families["torch"] is original


WIRE_DTYPES = [torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64,
               torch.float16, torch.float32, torch.float64, torch.complex64]


def _tensor(dtype, shape=(6, 5), seed=1):
    a = np.random.default_rng(seed).standard_normal(shape) * 50
    return torch.from_numpy(a).to(dtype)


WIRE_CASES = [(dtype, case) for dtype in WIRE_DTYPES for case in ("contiguous", "strided")] + [
    (dtype, "requires_grad") for dtype in WIRE_DTYPES if dtype.is_floating_point or dtype.is_complex]


@pytest.mark.parametrize("dtype, case", WIRE_CASES, ids=lambda x: str(x))
def test_cpu_wire_equals_the_reference(dtype, case):
    t = _tensor(dtype)
    if case == "strided":
        t = t.t()
    elif case == "requires_grad":
        t.requires_grad_(True)
    header, frames = torch_dumps(t)
    ref_header, ref_frames = ref_ser._torch_dumps(t)
    assert header == ref_header and "device" not in header
    assert [bytes(f) for f in frames] == [bytes(f) for f in ref_frames]
    got, want = torch_loads(header, frames), ref_ser._torch_loads(ref_header, ref_frames)
    assert got.dtype == want.dtype and got.device == want.device == torch.device("cpu")
    assert got.requires_grad == want.requires_grad
    assert torch.equal(got.detach(), want.detach())
    # each side reads the other's wire
    assert torch.equal(ref_ser._torch_loads(header, frames).detach(), t.detach())


def test_round_trip_through_the_reference_serialize(wire):
    assert ref_ser.families["torch"] == (torch_dumps, torch_loads)
    t = _tensor(torch.float32, (33, 4))
    header, frames = ref_ser.serialize(t)
    assert header["serializer"] == "torch"
    back = ref_ser.deserialize(header, frames)
    assert back.dtype == t.dtype and torch.equal(back, t)


def test_a_cuda_header_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    header, frames = torch_dumps(_tensor(torch.float32))
    header["device"] = "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_loads(header, frames)


def test_a_tensor_on_another_device_has_no_wire():
    with pytest.raises(ValueError, match="no wire"):
        torch_dumps(torch.zeros(4, device="meta"))


def test_bfloat16_takes_the_pickle_fallback_as_a_jax_array(wire):
    t = _tensor(torch.bfloat16, (8, 3))
    with pytest.raises(TypeError):
        torch_dumps(t)
    header, frames = ref_ser.serialize(t)
    jax_header, _ = ref_ser.serialize(jnp.asarray(np.zeros((8, 3), np.float32), jnp.bfloat16))
    assert header["serializer"] == jax_header["serializer"] == "pickle"
    back = ref_ser.deserialize(header, frames)
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)


def test_install_serialization_counts_and_restores_the_family():
    original = ref_ser.families["torch"]
    first = install_serialization(ref_ser.register_serialization_family, ref_ser.families)
    second = install_serialization(ref_ser.register_serialization_family, ref_ser.families)
    try:
        assert install_count("serialization", ref_ser.families) == 2
        first.uninstall()
        assert ref_ser.families["torch"] == (torch_dumps, torch_loads)
    finally:
        second.uninstall()
    assert ref_ser.families["torch"] is original
    assert install_count("serialization", ref_ser.families) == 0


# ------------------------------------------------------------ the device trace


@pytest.fixture
def profiled():
    originals = {name: getattr(ref_profile, name) for name in PROFILE_FUNCTIONS}
    handle = device_profile.install_device_profile(ref_profile, device="cpu")
    yield handle
    handle.uninstall()
    assert all(getattr(ref_profile, name) is fn for name, fn in originals.items())
    assert not device_profile.active()


def _native_tid(i):
    with torch.no_grad():
        a = torch.full((16, 16), float(i))
        (a @ a).sum()
    return threading.get_native_id()


async def _traced_cluster():
    """The reference's sequence (tests/test_observability.py:531-570) on a
    one-worker LocalCluster: start OK, a second start an error, four tasks,
    stop OK with files, an idle stop an error.  Returns (the loaded trace,
    each task's key and the native thread id it ran on)."""
    async with LocalCluster(n_workers=1, threads_per_worker=1) as cluster:
        async with Client(cluster.scheduler_address) as c:
            started = await c.device_profile_start()
            assert all(r["status"] == "OK" for r in started.values()), started
            again = await c.device_profile_start()
            assert all(r["status"] == "error" for r in again.values())
            futs = c.map(_native_tid, range(4), pure=False)
            tids = await asyncio.wait_for(c.gather(futs), 60)
            stopped = await c.device_profile_stop()
            (rep,) = stopped.values()
            assert rep["status"] == "OK", rep
            assert rep["files"] == [device_profile.TRACE_FILE]
            idle = await c.device_profile_stop()
            assert all(r["status"] == "error" for r in idle.values())
    with open(os.path.join(rep["logdir"], device_profile.TRACE_FILE)) as f:
        trace = json.load(f)
    return trace, [(f.key, tid) for f, tid in zip(futs, tids)]


@gen_test(timeout=120)
async def test_a_traced_cluster_puts_every_task_on_its_pool_thread(profiled):
    trace, tasks = await _traced_cluster()
    loop_tid = threading.get_native_id()
    for key, tid in tasks:
        assert tid != loop_tid
        spans = chip_smoke.task_spans(trace, key)
        assert [s["tid"] for s in spans] == [tid], (key, tid, spans)


@gen_test(timeout=120)
async def test_without_all_threads_the_trace_holds_no_task(profiled, monkeypatch):
    """The same run traced without ``profile_all_threads``: not one task's
    span is recorded, which is why the option is required."""
    from torch._C._profiler import _ExperimentalConfig

    monkeypatch.setattr(device_profile, "all_threads_config", _ExperimentalConfig)
    trace, tasks = await _traced_cluster()
    assert all(chip_smoke.task_spans(trace, key) == [] for key, _ in tasks)


def test_start_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_profile.start()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_profile.install_device_profile(ref_profile)
    assert not device_profile.active()


def test_a_torch_without_all_threads_gets_an_error_not_a_trace(monkeypatch):
    monkeypatch.setattr(device_profile, "all_threads_config", lambda: None)
    assert device_profile.available() is False
    rep = device_profile.start(device="cpu")
    assert rep["status"] == "error" and "profile_all_threads" in rep["error"]
    assert not device_profile.active()


def test_annotate_is_a_span_only_while_tracing(tmp_path):
    assert isinstance(device_profile.annotate("k"), contextlib.nullcontext)
    assert device_profile.stop()["status"] == "error"
    assert device_profile.start(str(tmp_path), device="cpu")["status"] == "OK"
    try:
        assert device_profile.active()
        assert isinstance(device_profile.annotate("k"), torch.profiler.record_function)
    finally:
        rep = device_profile.stop()
    assert rep["status"] == "OK" and rep["files"] == [device_profile.TRACE_FILE]
    assert not device_profile.active()


def test_install_device_profile_counts_and_restores_the_module(tmp_path):
    originals = {name: getattr(ref_profile, name) for name in PROFILE_FUNCTIONS}
    first = device_profile.install_device_profile(ref_profile, device="cpu")
    second = device_profile.install_device_profile(ref_profile, device="cpu")
    try:
        assert install_count("device_profile", ref_profile) == 2
        assert ref_profile.active is device_profile.active
        with pytest.raises(ValueError, match="installed here"):
            device_profile.install_device_profile(ref_profile, device="meta")
        first.uninstall()
        assert ref_profile.start(str(tmp_path))["status"] == "OK"  # the port's start, on the CPU
    finally:
        second.uninstall()  # the last one stops the running trace
    assert not device_profile.active()
    assert (tmp_path / device_profile.TRACE_FILE).exists()
    assert all(getattr(ref_profile, name) is fn for name, fn in originals.items())
    assert install_count("device_profile", ref_profile) == 0


def _event(cat, name, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def _card_trace(launch_tid):
    """A trace as torch.profiler writes one on the card (the shape of phase
    11's): the task's span on thread 7 with K2 launched inside it, the
    profiler's device-side annotation over that kernel on stream 20, a
    second K2 launched after the span on the same thread, and a launch of
    another thread inside the span's time.  ``launch_tid`` is the thread id
    the runtime events carry (the profiler can give a new thread a
    finished one's)."""
    return {"traceEvents": [
        _event("user_annotation", "task-a", 7, 100.0, 50.0, **{"External id": 5}),
        _event("cuda_runtime", "cudaLaunchKernel", launch_tid, 110.0, 5.0, correlation=1),
        _event("kernel", "k2", 20, 98.0, 30.0, correlation=1),  # the device's clock
        _event("gpu_user_annotation", "task-a", 20, 98.0, 30.0, **{"External id": 5}),
        _event("cuda_runtime", "cudaLaunchKernel", launch_tid, 160.0, 5.0, correlation=2),
        _event("kernel", "k2", 20, 140.0, 30.0, correlation=2),
        _event("cuda_runtime", "cudaLaunchKernel", 8, 120.0, 5.0, correlation=3),
        _event("kernel", "k2", 21, 180.0, 30.0, correlation=3),
    ]}


@pytest.mark.parametrize("launch_tid", [7, 6], ids=["tid", "inherited-tid"])
def test_task_kernels_are_the_profilers_own_attribution(launch_tid):
    """The task's kernel is the one the profiler put under its span's
    External id, launched while the span was open: not the later launch of
    the same kernel, not another thread's launch in the span's time, and
    whatever thread id the runtime events carry."""
    trace = _card_trace(launch_tid)
    found = chip_smoke.task_kernels(trace, "task-a")
    assert [(launch["args"]["correlation"], kernel["args"]["correlation"])
            for _, launch, kernel in found] == [(1, 1)]
    assert chip_smoke.task_kernels(trace, "task-b") == []


def test_task_kernels_need_the_launch_inside_the_span():
    trace = _card_trace(7)
    trace["traceEvents"][1]["ts"] = 151.0  # the launch after the span closed
    assert chip_smoke.task_kernels(trace, "task-a") == []


class _ExportOnly:
    """A stand-in profiler that records its activities and exports a
    given trace."""

    def __init__(self, trace, **kwargs):
        self.trace, self.kwargs = trace, kwargs

    def prepare_trace(self):
        pass

    def start_trace(self):
        pass

    def stop(self):
        pass

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump(self.trace, f)


@pytest.mark.parametrize("lose", [False, True], ids=["whole", "a-kernel-lost"])
def test_stop_refuses_a_cuda_trace_that_lacks_a_kernel(tmp_path, monkeypatch, lose):
    """A CUDA trace whose launch has no kernel event (the profiler dropped
    it) stops with an ``error`` status and keeps its file (a stand-in
    profiler and card: this box has neither)."""
    trace = _card_trace(7)
    if lose:
        trace["traceEvents"] = [e for e in trace["traceEvents"]
                                if not (e["cat"] == "kernel" and e["args"]["correlation"] == 2)]
    assert device_profile.lost_launches(trace) == (int(lose), 3)
    # in launch order: correlation 1 at 110, 3 at 120, 2 at 160
    assert device_profile.launch_pairs(trace) == [(110.0, 98.0), (120.0, 180.0),
                                                  (160.0, None if lose else 140.0)]
    made = []
    monkeypatch.setattr(torch.profiler, "profile",
                        lambda **kw: made.append(_ExportOnly(trace, **kw)) or made[-1])
    monkeypatch.setattr(device_profile, "resolve_device", lambda device: torch.device("cuda", 0))
    settled, slept = [], []
    monkeypatch.setattr(device_profile, "_settle", settled.append)
    monkeypatch.setattr(device_profile.time, "sleep", slept.append)
    assert device_profile.start(str(tmp_path))["status"] == "OK"
    assert torch.profiler.ProfilerActivity.CUDA in made[0].kwargs["activities"]
    assert settled == [torch.device("cuda", 0)]  # kernels before the capture window opens
    assert slept == [device_profile.EDGE_S]  # and none of the caller's at its edge
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    rep = device_profile.stop()
    assert synced == [torch.device("cuda", 0)] and slept == [device_profile.EDGE_S] * 2
    assert not device_profile.active()
    assert rep["files"] == [device_profile.TRACE_FILE] and rep["logdir"] == str(tmp_path)
    if lose:
        assert rep["status"] == "error" and "1 of its 3 kernel launches" in rep["error"]
    else:
        assert rep["status"] == "OK"


# ------------------------------------------------------------ build info


LABELS = ["role", "version", "torch", "cuda", "backend", "device", "mesh"]


def _labels(line: str) -> dict:
    body = line[line.index("{") + 1: line.rindex("}")]
    return dict(part.split("=", 1) for part in body.split(","))


def test_build_info_names_the_ports_runtime():
    (text,) = build_info_lines("worker", mesh="False/auto", device="cpu")
    line = [ln for ln in text.splitlines() if ln.startswith("dtpu_build_info{")][0]
    assert line.endswith(" 1")
    labels = _labels(line)
    assert list(labels) == LABELS
    assert labels == {"role": '"worker"', "version": f'"{__version__}"',
                      "torch": f'"{torch.__version__}"', "cuda": f'"{torch.version.cuda}"',
                      "backend": '"cpu"', "device": '"cpu"', "mesh": '"False/auto"'}
    assert all(v != '""' for v in labels.values())


def test_install_build_info_counts_and_restores_the_module():
    original = http_server.build_info_lines
    cache = http_server._BUILD_INFO_CACHE
    http_server.build_info_lines("worker")  # the reference's line, cached
    first = install_build_info(http_server, dtpu_config.get, device="cpu")
    second = install_build_info(http_server, dtpu_config.get, device="cpu")
    try:
        assert install_count("build_info", http_server) == 2
        assert cache == {}  # the reference's cached line is gone
        mesh = (f"{dtpu_config.get('scheduler.jax.mesh.enabled')}"
                f"/{dtpu_config.get('scheduler.jax.mesh.layout')}")
        for role in ("scheduler", "worker"):
            (text,) = http_server.build_info_lines(role)
            line = [ln for ln in text.splitlines() if ln.startswith("dtpu_build_info{")][0]
            assert f'role="{role}"' in line and line.endswith(" 1")
            assert _labels(line)["mesh"] == f'"{mesh}"' and 'backend="cpu"' in line
        first.uninstall()
        assert http_server.build_info_lines is not original
    finally:
        second.uninstall()
    assert http_server.build_info_lines is original and http_server._BUILD_INFO_CACHE is cache
    assert cache == {}
    assert install_count("build_info", http_server) == 0
    assert "jax=" in http_server.build_info_lines("worker")[0]


# ------------------------------------------------------------ the entry twin


def _reference_entry():
    spec = importlib.util.spec_from_file_location("_graft_entry_ref", ROOT / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.entry


def test_entry_equals_the_reference_bit_for_bit():
    fn, args = _reference_entry()()
    want = [np.asarray(x) for x in fn(*args)]
    pfn, pargs = entry(device="cpu")
    for _ in range(2):  # each call starts from the run's initial state
        got = [x.numpy() for x in pfn(*pargs)]
        for name, g, w in zip(("assign", "choices", "load", "spans"), got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), name


def test_dryrun_multichip_passes_on_the_cpu():
    line = dryrun_multichip(8, device="cpu")
    assert "mesh 4x2" in line and "bit for bit with single-device" in line
