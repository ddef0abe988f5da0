"""The port's host libraries: ``graphpack.cpp`` and ``tdigest.cpp``, each
built with ``g++`` and loaded with ``ctypes``.

``tdigest.cpp`` is the port's copy of the reference package's ``native/tdigest.cpp``
(the streaming quantile sketch behind ``utils/counter.Digest``); it
builds into a library of its own (:func:`load_tdigest`), so the pack's
library and its entry points stay as they were.

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
TDIGEST_SOURCE = Path(__file__).resolve().parent / "tdigest.cpp"
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

_vp = ctypes.c_void_p
_f64p = ctypes.POINTER(ctypes.c_double)
#: the t-digest's entry points (``tdigest.cpp``'s ``extern "C"`` block)
TDIGEST_SIGNATURES = {
    "tdigest_new": (_vp, (_f64,)),
    "tdigest_free": (None, (_vp,)),
    "tdigest_add": (None, (_vp, _f64, _f64)),
    "tdigest_add_batch": (None, (_vp, _f64p, _i64)),
    "tdigest_quantile": (_f64, (_vp, _f64)),
    "tdigest_count": (_f64, (_vp,)),
    "tdigest_min": (_f64, (_vp,)),
    "tdigest_max": (_f64, (_vp,)),
    "tdigest_serialize": (_i64, (_vp, _f64p, _i64)),
    "tdigest_merge_serialized": (None, (_vp, _f64p, _i64)),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tdigest_lib: ctypes.CDLL | None = None


def library_path(source: Path | None = None, stem: str = "libdtpu_host") -> Path:
    """Where the library for the current source (``SOURCE`` by default)
    and flags lives."""
    source = SOURCE if source is None else source
    h = hashlib.sha256(" ".join((CXX, *FLAGS)).encode())
    h.update(source.read_bytes())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def _compile(out: Path, source: Path | None = None) -> None:
    source = SOURCE if source is None else source
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    try:
        proc = subprocess.run(
            [CXX, *FLAGS, str(source), "-o", str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=300,
        )
    except FileNotFoundError as exc:
        raise RuntimeError(f"{CXX} not found: cannot build {source.name}") from exc
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{CXX} failed on {source.name}:\n{proc.stdout}")
    os.replace(tmp, out)


def _bind(lib: ctypes.CDLL, signatures: dict) -> ctypes.CDLL:
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = list(argtypes)
    return lib


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
        _lib = _bind(ctypes.CDLL(str(out)), SIGNATURES)
        return _lib


def load_tdigest() -> ctypes.CDLL:
    """The t-digest library, built at first use.  Raises ``RuntimeError``
    when it cannot be built."""
    global _tdigest_lib
    with _lock:
        if _tdigest_lib is not None:
            return _tdigest_lib
        out = library_path(TDIGEST_SOURCE, "libdtpu_tdigest")
        if not out.exists():
            _compile(out, TDIGEST_SOURCE)
        _tdigest_lib = _bind(ctypes.CDLL(str(out)), TDIGEST_SIGNATURES)
        return _tdigest_lib


_CTYPES = {"int32": ctypes.c_int32, "float32": ctypes.c_float, "int8": ctypes.c_int8}


def as_ptr(arr):
    """A ctypes pointer to a contiguous int32, float32 or int8 numpy
    array, which the caller keeps alive for the length of the call."""
    if not arr.flags.c_contiguous or arr.dtype.name not in _CTYPES:
        raise ValueError(f"native calls take contiguous {sorted(_CTYPES)} arrays, "
                         f"got {arr.dtype} (contiguous {arr.flags.c_contiguous})")
    return arr.ctypes.data_as(ctypes.POINTER(_CTYPES[arr.dtype.name]))
