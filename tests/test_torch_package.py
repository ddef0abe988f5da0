"""Boundaries of the PyTorch port: no JAX, no reference package, no
silent CPU fallback, no fallback from a kernel that cannot be built."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import distributed_tpu_torch
from distributed_tpu_torch import graphs, native
from distributed_tpu_torch.ops import _build, flash, leveled, partition
from distributed_tpu_torch.scheduler import plan
from distributed_tpu_torch.scheduler.torch_placement import TorchPlacement

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "distributed_tpu_torch"
PORT_FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _module_names():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    )


_IMPORT_PROBE = """
import importlib, json, sys

FORBIDDEN = ("jax", "jaxlib", "distributed_tpu")
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
            assert root not in ("jax", "jaxlib", "distributed_tpu"), (
                f"{path.name}:{node.lineno} imports {name}"
            )


def _entry_calls():
    packed = leveled.pack_graph(*graphs.random_dag(20, seed=0))
    fleet = (np.full(2, 1, np.int32), np.zeros(2, np.float32), np.ones(2, bool))
    q = np.zeros((8, 1, 64), np.float32)
    graph = graphs.random_dag(20, seed=0)
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
    }


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


def test_library_path_keys_on_sources():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libdtpu_kernels-") and path.suffix == ".so"
    assert {p.name for p in _build.CSRC.glob("*.cu")} == {"flash_fwd.cu", "partition.cu",
                                                            "place_wave.cu"}


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
