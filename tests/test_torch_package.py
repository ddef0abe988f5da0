"""Boundaries of the PyTorch port: no JAX, no reference package, no
silent CPU fallback, no fallback from a kernel that cannot be built."""

from __future__ import annotations

import ast
import asyncio
import importlib
import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import test_torch_periodic_cases as cases

import distributed_tpu_torch
from distributed_tpu_torch import entry as entry_twin
from distributed_tpu_torch import graphs, native
from distributed_tpu_torch.cli import scheduler as cli_scheduler
from distributed_tpu_torch.deploy import LocalCluster, SpecCluster
from distributed_tpu_torch.diagnostics import device_profile
from distributed_tpu_torch.http import build_info
from distributed_tpu_torch.http import server as http_server
from distributed_tpu_torch.ops import (
    _build,
    amm,
    flash,
    ici,
    leveled,
    partition,
    placement,
    rebalance,
    ring_attention,
    sharded,
    stealing,
    ulysses,
    wavefront,
)
from distributed_tpu_torch.parallel import mesh as parallel_mesh
from distributed_tpu_torch.scheduler import plan
from distributed_tpu_torch.scheduler.mirror import TorchMirror
from distributed_tpu_torch.scheduler.periodic import install_periodic
from distributed_tpu_torch.scheduler.torch_placement import TorchPlacement
from distributed_tpu_torch.shuffle import device as device_shuffle
from distributed_tpu_torch.utils import sizeof as tensor_size  # noqa: F401
from distributed_tpu_torch.worker import join, setup  # noqa: F401

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)

# the protocol package exports the function ``serialize``, which shadows the module
wire = importlib.import_module("distributed_tpu_torch.protocol.serialize")
ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "distributed_tpu_torch"
# chip_smoke.py runs on a machine without JAX, and so does the test helper it imports
PORT_FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_periodic_cases.py"]


def _module_names():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    )


_IMPORT_PROBE = """
import importlib, json, sys

FORBIDDEN = ("jax", "jaxlib", "distributed_tpu", "msgpack", "cloudpickle", "yaml")
tried = []


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            tried.append(name)
            raise ImportError(name + " is off limits for the port")


before = set(sys.modules)
sys.meta_path.insert(0, Block())
for m in MODULES:
    importlib.import_module(m)
new = sorted(m for m in set(sys.modules) - before if m.split(".")[0] in FORBIDDEN)
print(json.dumps({"tried": tried, "new": new}))
"""


def test_import_pulls_in_no_jax_and_no_reference_package():
    code = f"MODULES = {_module_names()!r}\n" + _IMPORT_PROBE
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"tried": [], "new": []}


SHUFFLE_AND_COORDINATION = [
    "distributed_tpu_torch.coordination", "distributed_tpu_torch.coordination.extensions",
    "distributed_tpu_torch.coordination.objects", "distributed_tpu_torch.shuffle",
    "distributed_tpu_torch.shuffle.api", "distributed_tpu_torch.shuffle.buffers",
    "distributed_tpu_torch.shuffle.columnar", "distributed_tpu_torch.shuffle.core",
    "distributed_tpu_torch.shuffle.device", "distributed_tpu_torch.shuffle.scheduler_ext",
]


@pytest.mark.parametrize("module", SHUFFLE_AND_COORDINATION)
def test_the_shuffle_and_coordination_modules_are_checked(module):
    """The shuffle and coordination modules are among those the import
    probe loads and the source check reads, and each is the port's own:
    none of its imports names JAX or the reference package."""
    assert module in _module_names()
    path = ROOT / Path(*module.split("."))
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    assert path in PORT_FILES
    test_source_imports_no_jax_and_no_reference_package(path)


CLI_HTTP_AND_PROCESS_CLUSTERS = [
    "distributed_tpu_torch.cli", "distributed_tpu_torch.cli.scheduler",
    "distributed_tpu_torch.cli.spec", "distributed_tpu_torch.cli.ssh",
    "distributed_tpu_torch.cli.worker", "distributed_tpu_torch.comm.ws",
    "distributed_tpu_torch.deploy.ssh", "distributed_tpu_torch.deploy.subprocess",
    "distributed_tpu_torch.http.dashboard", "distributed_tpu_torch.http.server",
]


@pytest.mark.parametrize("module", CLI_HTTP_AND_PROCESS_CLUSTERS)
def test_the_cli_http_ws_and_process_cluster_modules_are_checked(module):
    """The command line, the http server and dashboard, ``ws://`` and the
    process clusters are among the modules the import probe loads and the
    source check reads, and none of their imports names JAX or the
    reference package."""
    test_the_shuffle_and_coordination_modules_are_checked(module)


ANALYSIS = sorted(m for m in _module_names() if m.startswith("distributed_tpu_torch.analysis"))


def test_every_module_of_the_references_linter_has_its_twin():
    """``distributed_tpu_torch/analysis`` has a counterpart of every file of
    ``distributed_tpu/analysis``, with ``launch_sync.py`` for ``jit_purity.py``."""
    ref = ROOT / "distributed_tpu" / "analysis"
    want = {p.relative_to(ref).as_posix().replace("jit_purity", "launch_sync")
            for p in ref.rglob("*.py")}
    got = {p.relative_to(PKG / "analysis").as_posix() for p in (PKG / "analysis").rglob("*.py")}
    assert got == want and len(ANALYSIS) == len(want)


@pytest.mark.parametrize("module", ANALYSIS)
def test_the_linter_imports_only_the_stdlib(module):
    """Each module of the port's linter is loaded by the import probe and
    read by the source check, and imports nothing but the standard
    library and its own package: no torch, no JAX, no reference.  The one
    exception is the CLI's ``import distributed_tpu_torch`` for the root."""
    test_the_shuffle_and_coordination_modules_are_checked(module)
    path = ROOT / Path(*module.split("."))
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            # the CLI finds the repo root from the package's own path
            # (``import distributed_tpu_torch``, whose __init__ loads torch)
            assert name.split(".")[0] in sys.stdlib_module_names or \
                name.startswith("distributed_tpu_torch.analysis") or \
                (module.endswith(".cli") and name == "distributed_tpu_torch"), \
                f"{module} imports {name}"


def test_the_process_clusters_are_exported_as_the_references():
    import distributed_tpu_torch.deploy as deploy

    assert {"SSHCluster", "SubprocessCluster"} <= set(distributed_tpu_torch._LAZY)
    assert distributed_tpu_torch.SubprocessCluster is deploy.SubprocessCluster
    assert distributed_tpu_torch.SSHCluster is deploy.SSHCluster
    assert {"SSHCluster", "SubprocessCluster", "SubprocessScheduler",
            "SubprocessWorker"} <= set(deploy.__all__)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_source_imports_no_jax_and_no_reference_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "distributed_tpu", "msgpack", "cloudpickle",
                                "yaml"), (
                f"{path.name}:{node.lineno} imports {name}"
            )


def _entry_calls():
    packed = leveled.pack_graph(*graphs.random_dag(20, seed=0))
    fleet = (np.full(2, 1, np.int32), np.zeros(2, np.float32), np.ones(2, bool))
    q = np.zeros((8, 1, 64), np.float32)
    graph = graphs.random_dag(20, seed=0)
    keys = np.arange(16, dtype=np.int32)
    workers = placement.WorkerArrays(*fleet[:2], np.zeros(2, np.float32), fleet[2])
    batch = placement.PlacementBatch(np.ones(4, np.float32), np.ones(4, bool), np.zeros(1, np.int32),
                                     np.zeros(1, np.int32), np.ones(1, np.float32),
                                     np.ones((1, 2), bool))
    return {
        "place_graph_leveled": lambda: leveled.place_graph_leveled(packed, *fleet),
        "place_graph_streamed": lambda: leveled.place_graph_streamed(
            *graph, *fleet, min_stream=1),
        "plan_from_arrays": lambda: plan.plan_from_arrays(
            list(range(20)), *graph, *fleet, ["a", "b"], 100e6),
        "LeveledRun": lambda: leveled.LeveledRun(packed, *fleet),
        "flash_attention": lambda: flash.flash_attention(q, q, q),
        "partition_padded": lambda: partition.partition_padded(
            graph[0], graph[1][graph[2]], graph[2], graph[3], 4),
        "PartitionRun": lambda: partition.PartitionRun(
            graph[0], graph[1][graph[2]], graph[2], graph[3], 4),
        "TorchPlacement": lambda: TorchPlacement(),
        "resolve_device": lambda: distributed_tpu_torch.resolve_device(None),
        "plan_steals": lambda: stealing.plan_steals(
            cases.steal_cycle(np.random.default_rng(0), 8, n_tasks=20)),
        "plan_drops": lambda: amm.plan_drops(
            cases.drop_round(np.random.default_rng(0), 10, 4, max_holders=4)),
        "plan_rebalance": lambda: rebalance.plan_rebalance(
            cases.rebalance_case(np.random.default_rng(0), 50, 4)),
        "TorchMirror.device_view": lambda: TorchMirror(cases.StandInState()).device_view(),
        "install_periodic": lambda: install_periodic(object()),
        "make_engine_mesh": lambda: partition.make_engine_mesh(),
        "place_graph_leveled_sharded": lambda: sharded.place_graph_leveled_sharded(
            partition.make_engine_mesh(layout="1x1"), packed, *fleet),
        "place_graph_streamed(mesh)": lambda: leveled.place_graph_streamed(
            *graph, *fleet, min_stream=1, mesh=partition.make_engine_mesh()),
        "TorchMirror.sharded_device_view": lambda: TorchMirror(
            cases.StandInState(), device="cpu").sharded_device_view(partition.make_engine_mesh()),
        "TorchPlacement(mesh)": lambda: TorchPlacement(mesh_enabled=True, mesh_layout="1x1"),
        "make_engine_mesh(cuda list)": lambda: partition.make_engine_mesh(devices=["cuda:0"]),
        "make_mesh_1d": lambda: ici.make_mesh_1d(),
        "make_mesh_1d(cuda list)": lambda: ici.make_mesh_1d(devices=["cuda:0"] * 2),
        "shuffle_on_mesh": lambda: ici.shuffle_on_mesh(ici.make_mesh_1d(), keys, keys[:, None]),
        "ring_exchange": lambda: ici.ring_exchange(ici.make_mesh_1d(), keys),
        "ring_attention": lambda: ring_attention.ring_attention(
            ici.make_mesh_1d(axis="sp"), q, q, q),
        "ulysses_attention": lambda: ulysses.ulysses_attention(
            ici.make_mesh_1d(axis="sp"), q, q, q),
        "DeviceRun.exchange": lambda: _device_run(keys).exchange(),
        "DeviceShuffleStore run": lambda: _store_run(keys).exchange(),
        "decide_workers": lambda: placement.decide_workers(workers, batch, 1e8),
        "build_batch_arrays": lambda: placement.build_batch_arrays(
            np.ones(4, np.float32), (np.zeros(1, np.int32), np.zeros(1, np.int32)),
            np.ones(1, np.float32), np.ones((1, 2), bool)),
        "place_rootish": lambda: placement.place_rootish(4, workers, max_tasks=8),
        "occupancy_after_finish": lambda: placement.occupancy_after_finish(
            fleet[1], fleet[0], np.zeros(1, np.int32), np.ones(1, np.float32)),
        "GraphArrays.from_arrays": lambda: wavefront.GraphArrays.from_arrays(*graph),
        "make_mesh": lambda: parallel_mesh.make_mesh(),
        "sharded_decide_workers": lambda: parallel_mesh.sharded_decide_workers(
            parallel_mesh.make_mesh(), workers, batch, 1e8),
        "entry": lambda: entry_twin.entry(),
        "dryrun_multichip": lambda: entry_twin.dryrun_multichip(2),
        "device_profile.start": lambda: device_profile.start(),
        "install_device_profile": lambda: device_profile.install_device_profile(
            types.ModuleType("device_profile")),
        "build_info_lines": lambda: build_info.build_info_lines("worker", mesh="False/auto"),
        "install_build_info": lambda: build_info.install_build_info(
            types.SimpleNamespace(_BUILD_INFO_CACHE={}), {}.get),
        "LocalCluster": lambda: LocalCluster(n_workers=0),
        "cli.scheduler": lambda: asyncio.run(cli_scheduler.run(
            cli_scheduler.make_parser().parse_args(["--port", "0"]))),
        "http build_info_lines": lambda: http_server.build_info_lines("scheduler", None),
        "SpecCluster": lambda: asyncio.run(SpecCluster(workers={})._start()),
        "torch_loads(cuda)": lambda: wire.torch_loads(
            {"dtype": "<f4", "shape": [1], "device": "cuda"}, [bytes(4)]),
    }


def _device_run(keys):
    run = device_shuffle.DeviceRun("s", 1, 1, 1)
    run.register(0, keys, keys[:, None])
    return run


def _store_run(keys):
    run = device_shuffle.DeviceShuffleStore().get_or_create("s", 1, 1, 1)
    run.register(0, keys, keys[:, None])
    return run


@pytest.mark.parametrize("entry", sorted(_entry_calls()))
def test_default_device_needs_cuda(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_calls()[entry]()


def test_explicit_cpu_device_runs():
    assert distributed_tpu_torch.resolve_device("cpu") == torch.device("cpu")


def test_build_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        _build.load()


def test_build_without_toolkit_raises(monkeypatch, tmp_path):
    """A machine with a card but no nvcc: the build raises, nothing
    falls back to the plain versions."""
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(cpp, "CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()
    assert not list(tmp_path.glob("*.so"))


def test_wrappers_raise_off_cpu_without_cuda():
    """Only CPU tensors take the plain versions: tensors on any other
    device go to the kernels, which raise without CUDA."""
    qt = torch.zeros(1, 64, 64, device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        flash.flash_forward(qt, qt, qt, False, 0.125)
    lse = torch.zeros(1, 64, 1, device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        flash.flash_backward(qt, qt, qt, qt, lse, qt, False, 0.125)
    packed = leveled.pack_graph(*graphs.random_dag(20, seed=0))
    run = leveled.LeveledRun(
        packed, np.ones(2, np.int32), np.zeros(2, np.float32), np.ones(2, bool),
        device="meta",
    )
    with pytest.raises(RuntimeError, match="CUDA"):
        leveled.place_wave(run, 0)
    graph = graphs.random_dag(20, seed=0)
    prun = partition.PartitionRun(graph[0], graph[1][graph[2]], graph[2], graph[3], 4,
                                  device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        partition.partition_rounds(prun)
    batch = cases.steal_cycle(np.random.default_rng(0), 8, n_tasks=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        stealing.steal_rounds(*(torch.as_tensor(np.asarray(a)).to("meta") for a in batch), 8)
    drop = cases.drop_round(np.random.default_rng(0), 10, 4, max_holders=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        amm.drop_rounds(*(torch.as_tensor(np.asarray(a)).to("meta") for a in drop), 4)
    keys = [torch.zeros(64, dtype=torch.int32, device="meta")]
    with pytest.raises(RuntimeError, match="CUDA"):
        ici.shuffle_bucket(keys, [torch.zeros(64, 4, device="meta")], None, 8, 16)


@pytest.mark.parametrize("fails", [False, True], ids=["returns", "raises"])
def test_launch_puts_the_threads_device_back(monkeypatch, fails):
    """A launch on card 0 from a thread whose current card is 1 runs with
    card 0 current and leaves card 1 current after it, also when the entry
    point raises (stand-ins for torch's device calls: this box has no card)."""
    current = {"index": 1}
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current["index"])
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: current.update(index=torch.device(d).index if not isinstance(d, int) else d))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 1000 + index, raising=False)
    seen = []

    def entry(a, b, stream):
        seen.append((a, b, current["index"], stream))
        if fails:
            raise RuntimeError("refused")
        return 0

    if fails:
        with pytest.raises(RuntimeError, match="refused"):
            _build.launch(torch.device("cuda", 0), entry, 7, 8)
    else:
        assert _build.launch(torch.device("cuda", 0), entry, 7, 8) == 0
    assert seen == [(7, 8, 0, 1000)]
    assert current["index"] == 1


def test_launch_sets_the_device_once_a_thread(monkeypatch):
    """A thread's first launch on a card sets it current even when torch
    already reads it as current (on a new thread torch reads card 0, and
    the library's runtime has no context there); later launches on it set
    nothing; a launch on another card sets that one and puts the thread's
    back (stand-ins for torch's device calls: this box has no card)."""
    import threading

    current = {"index": 0}
    calls = []

    def set_device(d):
        calls.append(d)
        current["index"] = d

    monkeypatch.setattr(_build, "_thread", threading.local())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current["index"])
    monkeypatch.setattr(torch.cuda, "set_device", set_device)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 1000 + index, raising=False)
    streams = []
    for index in (0, 0, 0, 1, 0):
        assert _build.launch(torch.device("cuda", index), lambda stream: streams.append(stream) or 0) == 0
    assert calls == [0, 1, 0] and current["index"] == 0
    assert streams == [1000, 1000, 1000, 1001, 1000]

    def other_thread():
        _build.launch(torch.device("cuda", 0), lambda stream: 0)

    t = threading.Thread(target=other_thread)
    t.start()
    t.join()
    assert calls == [0, 1, 0, 0]


def test_library_path_keys_on_sources():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libdtpu_kernels-") and path.suffix == ".so"
    assert {p.name for p in _build.CSRC.glob("*.cu")} == {
        "amm_drop.cu", "flash_bwd.cu", "flash_fwd.cu", "fleet_scatter.cu", "partition.cu",
        "place_shard.cu", "place_wave.cu", "rebalance.cu", "shuffle_bucket.cu", "steal.cu"}
    assert {p.name for p in _build.CSRC.glob("*.cuh")} == {"hopper.cuh"}


def test_library_path_keys_on_headers(monkeypatch, tmp_path):
    """An edited header alone (no source touched) names a new library, so
    a stale build of the old header is never loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.library_path()
    assert before == _build.library_path()
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path() != before


def test_build_dir_is_ignored_by_git():
    out = subprocess.run(
        ["git", "check-ignore", "-q", str(_build.BUILD_DIR / "x.o")],
        cwd=ROOT, capture_output=True,
    )
    assert out.returncode == 0


def test_host_library_is_the_ports_own():
    """The port builds its own copy of graphpack.cpp with its own loader;
    neither names the reference package's native directory."""
    assert native.SOURCE.parent == PKG / "native"
    for path in (native.SOURCE, PKG / "native" / "__init__.py"):
        text = path.read_text()
        for name in ("distributed_tpu/native", "distributed_tpu.native"):
            assert name not in text, f"{path.name} names {name}"


@pytest.mark.parametrize("script", sorted(p.name for p in PKG.glob("profile_*.py")))
def test_profile_scripts_start_as_scripts(script):
    """Each profile script runs as ``python3 distributed_tpu_torch/<script>``,
    where its own directory leads ``sys.path``: the package's ``http`` must
    not hide the standard library's from torch."""
    out = subprocess.run([sys.executable, str(PKG / script), "--help"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
