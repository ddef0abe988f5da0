"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process
per source, all started together), linked into one shared library with a
plain C interface, and loaded with ``ctypes``.  The library lands in
``build/torch_kernels/`` at the repository root under a name keyed on
the sources, the headers beside them and the flags, so an edited source
or header is rebuilt at its next use.
A build that fails raises: there is no fallback.  nvcc's output (ptxas's
registers and spills) is kept beside the library, so a process that
finds the library built still reads it (``build_info["log"]``).

Each C entry point launches on the stream it is given (:func:`launch`
calls it on the device's current stream), allocates nothing and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception.
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
    "dtpu_place_shard": (
        _vp, _vp, _vp, _vp, _vp, _vp,   # dur16 heavy heavy2 xp16 xp2_16 xa16 (tiles)
        _vp, _vp, _vp,                  # shard_ids assign load
        _vp, _vp, _vp, _vp,             # inv_t running ovt0 tl (null in launch A)
        _vp, _vp, _vp, _vp,             # tgt wt spread sorted (scratch)
        _vp, _vp, _vp,                  # cnt start tot (scratch)
        _vp, _vp, _vp,                  # part aslice cslice (out)
        _i, _i, _i, _i, _i, _i, _i,     # W S K Fl k f w_run
        _i, _i, _i,                     # uniform contend bx
        _f, _f,                         # ovt_c inv_c
        _vp,                            # stream
    ),
    "dtpu_place_shard_run": (
        _vp, _vp, _vp, _vp, _vp, _vp,   # dur16 heavy heavy2 xp16 xp2_16 xa16 (tiles)
        _vp, _vp,                       # shard_ids waves (i32 [3, K]: offs fs widxs)
        _vp, _vp, _vp, _vp,             # assign choices load spans (the carry, in place)
        _vp, _vp, _vp,                  # inv_t running ovt0
        _vp, _vp, _vp, _vp, _vp,        # tl tgt wt spread sorted (scratch)
        _vp, _vp, _vp,                  # cnt start tot (scratch)
        _i, _i, _i, _i, _i, _i, _i,     # W S K Fl w_run uniform bx
        _f, _f,                         # ovt_c inv_c
        _vp,                            # stream
    ),
    "dtpu_place_shard_grid": (_i, _i, ctypes.POINTER(_i)),  # W S -> blocks per shard
    "dtpu_partition": (
        _vp, _vp, _vp, _vp,             # init lab0 lab1 durations
        _vp, _vp, _vp, _vp, _vp, _vp,   # in_off in_nbr in_w out_off out_nbr out_w
        _vp, _vp, _vp,                  # blocked cnt sorted (counting sort, W <= 64)
        _vp,                            # stamps (optional timeline, or null)
        _i, _i, _i, _f, _f, _i, _i,     # T W iters thresh bonus blocks cnt_blocks
        _vp,                            # stream
    ),
    "dtpu_steal_layout": (_i, _i, ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(_i)),
    "dtpu_steal": (
        _vp, _vp, _vp, _vp, _vp, _vp,   # victim key cost compute nthreads running
        _vp, _vp, _vp, _vp,             # occ idle (in/out) thief_of taken
        _vp,                            # scratch: null = shared memory
        _vp,                            # stamps (optional timeline, or null)
        _i, _i, _i,                     # T W rounds
        _vp,                            # stream
    ),
    "dtpu_amm_drop_grid": (_i, ctypes.POINTER(_i)),  # W -> blocks
    "dtpu_amm_drop": (
        _vp, _vp, _vp, _vp, _vp,        # holders excluded nbytes ndrop mem
        _vp, _vp, _vp,                  # drops scratch list
        _vp,                            # stamps (optional timeline, or null)
        _i, _i, _i, _i,                 # R W K blocks
        _vp,                            # stream
    ),
    "dtpu_rebalance_layout": (_i, ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(_i)),
    "dtpu_rebalance": (
        _vp, _vp, _vp,                  # list size off (owner_lists)
        _f, _f, _vp,                    # hi lo mem (in/out)
        _vp, _vp, _vp,                  # moves counts total (out)
        _vp,                            # work: null = shared memory
        _vp,                            # stamps (optional timeline, or null)
        _i, _i, _i,                     # W K cap
        _vp,                            # stream
    ),
    "dtpu_fleet_scatter": (
        _vp, _i, _i,                    # records (device address of pinned host memory) jobs rows
        _vp, ctypes.c_ulonglong,        # done (mapped host word, or null) seq
        _vp, ctypes.c_ulonglong,        # count (device word) target
        _vp,                            # stream
    ),
    "dtpu_fleet_device_address": (_vp, ctypes.POINTER(_vp)),  # pinned host -> its device address
    "dtpu_shuffle_bucket": (
        _vp, _vp, _vp, _vp, _vp,        # key, value, valid, send_k, send_v pointer tables
        _vp, _vp,                       # sent [S, n_dev] hist (scratch [S, tiles, n_dev])
        _i, _i, _i, _i, _i, _i,         # S n n_dev cap row_bytes vec
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
        saved = out.with_suffix(".log")  # nvcc's output when it built the library
        if out.exists():
            log = saved.read_text() if saved.exists() else "(cached)"
        else:
            log = _compile(out)
            saved.write_text(log)
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


_thread = threading.local()


def launch(device: torch.device, entry, *args) -> int:
    """Call the C entry point ``entry(*args, stream)`` on ``device``'s
    current stream, with ``device`` the calling thread's current device
    for the call and the thread's own put back after it.  The library
    links its own CUDA runtime, which launches in the thread's current
    context: on a thread where torch never set a device (a worker's task
    thread) there is none, and a launch fails with cudaErrorInvalidValue,
    so ``set_device`` makes the device's context current the first time
    this thread launches on it (torch reads card 0 as current on such a
    thread) and whenever the thread's current card differs; otherwise the
    context is already current and nothing is set.  Putting the thread's
    device back keeps a launch from moving its caller's default card (a
    mesh over several cards launches on each in turn)."""
    index = device.index
    seen = getattr(_thread, "cards", None)
    if seen is None:
        seen = _thread.cards = set()
    prev = torch.cuda.current_device()
    if prev != index or index not in seen:
        torch.cuda.set_device(index)
        seen.add(index)
    try:
        return entry(*args, torch._C._cuda_getCurrentRawStream(index))
    finally:
        if prev != index:
            torch.cuda.set_device(prev)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
