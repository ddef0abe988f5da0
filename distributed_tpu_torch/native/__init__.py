"""The port's host library: ``graphpack.cpp`` built with ``g++`` and
loaded with ``ctypes``.

The library is built at first use into ``build/torch_host/`` at the
repository root, under a name keyed on the source and the flags, so an
edited source is rebuilt at its next use.  It links through a temporary
file and ``os.replace``, so processes that build at once each land a
whole library.  A build that fails raises: there is no fallback to the
numpy pack.

``ctypes.CDLL`` releases the GIL for the length of every call; the
streamed driver's filler thread relies on that to fill rows while the
calling thread uploads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "graphpack.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_host"
CXX = "g++"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_i64 = ctypes.c_int64
_f64 = ctypes.c_double
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_i8p = ctypes.POINTER(ctypes.c_int8)
# C signature of every entry point: (restype, argtypes)
SIGNATURES = {
    "graphpack_full": (_i64, (
        _i64, _i64,                          # T E
        _f32p, _f32p, _i32p, _i32p,          # durations out_bytes src dst
        _f64, _f64,                          # inv_bandwidth latency
        _i32p, _i32p, _i32p,                 # level perm offsets
        _f32p, _i32p, _i32p, _f32p, _f32p, _f32p,  # dur_s heavy_s heavy2_s xp xp2 xa
    )),
    "graphpack_topo": (_i64, (
        _i64, _i64,                          # T E
        _f32p, _i32p, _i32p,                 # out_bytes src dst
        _i32p, _i32p, _i32p,                 # level perm offsets
        _i32p, _i32p, _f32p, _i32p, _i32p,   # heavy heavy2 dep_total indeg inv
    )),
    "graphpack_fill": (None, (
        _i64, _i64,                          # i0 i1
        _f32p, _f32p, _i32p, _i32p,          # durations out_bytes perm inv
        _i32p, _i32p, _f32p, _i32p,          # heavy heavy2 dep_total indeg
        _f64, _f64,                          # inv_bandwidth latency
        _f32p, _i32p, _i32p, _f32p, _f32p, _f32p,  # dur_s heavy_s heavy2_s xp xp2 xa
    )),
    "unpack_assignment": (None, (
        _i64, _i32p, _i32p,                  # T codes perm
        _i32p, _i8p,                         # assignment choice
    )),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join((CXX, *FLAGS)).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libdtpu_host-{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    try:
        proc = subprocess.run(
            [CXX, *FLAGS, str(SOURCE), "-o", str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=300,
        )
    except FileNotFoundError as exc:
        raise RuntimeError(f"{CXX} not found: cannot build {SOURCE.name}") from exc
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{CXX} failed on {SOURCE.name}:\n{proc.stdout}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The host library, built at first use.  Raises ``RuntimeError``
    when it cannot be built."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            _compile(out)
        lib = ctypes.CDLL(str(out))
        for name, (restype, argtypes) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = list(argtypes)
        _lib = lib
        return lib


_CTYPES = {"int32": ctypes.c_int32, "float32": ctypes.c_float, "int8": ctypes.c_int8}


def as_ptr(arr):
    """A ctypes pointer to a contiguous int32, float32 or int8 numpy
    array, which the caller keeps alive for the length of the call."""
    if not arr.flags.c_contiguous or arr.dtype.name not in _CTYPES:
        raise ValueError(f"native calls take contiguous {sorted(_CTYPES)} arrays, "
                         f"got {arr.dtype} (contiguous {arr.flags.c_contiguous})")
    return arr.ctypes.data_as(ctypes.POINTER(_CTYPES[arr.dtype.name]))
