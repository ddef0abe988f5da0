"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process
per source, all started together), linked into one shared library with a
plain C interface, and loaded with ``ctypes``.  The library lands in
``build/torch_kernels/`` at the repository root under a name keyed on
the sources, the headers beside them and the flags, so an edited source
or header is rebuilt at its next use.
A build that fails raises: there is no fallback.

Each C entry point launches on the stream it is given, allocates
nothing and returns ``cudaGetLastError()``; :func:`check` turns a
non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_vp = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float
# C signature of every entry point: (argtypes); each returns cudaError_t
SIGNATURES = {
    "dtpu_place_waves": (
        _vp, _vp, _vp, _vp, _vp, _vp,   # dur16 heavy heavy2 xp16 xp2_16 xa16
        _vp,                            # cost_table: null = f16 wire, else the packed wire's
        _vp, _vp, _vp, _vp,             # assign choices load spans
        _vp, _vp, _vp, _vp,             # inv_t running ovt0 offsets
        _vp, _vp, _vp, _vp, _vp,        # tl wave_load tgt wt sorted (scratch)
        _vp, _vp, _vp,                  # cnt start tot (scratch)
        _vp,                            # stamps (optional timeline, or null)
        _i, _i, _i, _i, _i, _i,         # W first last w_run uniform blocks
        _f, _f,                         # ovt_c inv_c
        _vp,                            # stream
    ),
    "dtpu_place_waves_grid": (_i, _i, ctypes.POINTER(_i)),  # W uniform -> blocks
    "dtpu_partition": (
        _vp, _vp, _vp, _vp,             # init lab0 lab1 durations
        _vp, _vp, _vp, _vp, _vp, _vp,   # in_off in_nbr in_w out_off out_nbr out_w
        _vp, _vp, _vp,                  # blocked cnt sorted (counting sort, W <= 64)
        _vp,                            # stamps (optional timeline, or null)
        _i, _i, _i, _f, _f, _i, _i,     # T W iters thresh bonus blocks cnt_blocks
        _vp,                            # stream
    ),
    "dtpu_flash_fwd": (
        _vp, _vp, _vp, _vp, _vp,        # q k v o lse
        _i, _i, _i, _i, _i, _i,         # H N Nk D dtype causal
        _f,                             # scale
        _vp,                            # stream
    ),
    "dtpu_flash_bwd": (
        _vp, _vp, _vp, _vp, _vp, _vp,   # q k v o lse dout
        _vp, _vp, _vp, _vp,             # dq dk dv scratch (delta, padded lse)
        _i, _i, _i, _i, _i, _i,         # H N Nk D dtype causal
        _f,                             # scale
        _vp,                            # stream
    ),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_info: dict = {}  # path and nvcc log of the library this process loaded


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: no CUDA toolkit (CUDA_HOME unset)")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def _sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> Path:
    """Where the library for the current sources, the headers they
    include (``csrc/*.cuh``) and the flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdtpu_kernels-{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> str:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    objs, procs = [], []
    for src in _sources():
        obj = out.with_name(f"{out.stem}-{src.stem}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    logs, failed = [], []
    for src, proc in zip(_sources(), procs):
        text, _ = proc.communicate()
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode:
            failed.append(src.name)
    if failed:
        raise RuntimeError(
            f"nvcc failed on {', '.join(failed)}:\n" + "\n".join(logs)
        )
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, out)
    for obj in objs:
        obj.unlink()
    return "\n".join(logs)


def load() -> ctypes.CDLL:
    """The kernel library, built at first use.  Raises ``RuntimeError``
    without a CUDA device or toolkit, or when a source does not build."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not torch.cuda.is_available():
            raise RuntimeError("the CUDA kernels need a CUDA device")
        out = library_path()
        log = _compile(out) if not out.exists() else "(cached)"
        lib = ctypes.CDLL(str(out))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        build_info.update(path=str(out), log=log)
        _lib = lib
        return lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
