"""The port's host libraries: ``graphpack.cpp``, ``tdigest.cpp`` and
``engine.cpp``, each built with ``g++`` and loaded with ``ctypes``.

``tdigest.cpp`` is the port's copy of the reference package's ``native/tdigest.cpp``
(the streaming quantile sketch behind ``utils/counter.Digest``); it
builds into a library of its own (:func:`load_tdigest`), so the pack's
library and its entry points stay as they were.  ``engine.cpp`` is a byte
copy of the reference's native transition core (the C++ half of
``scheduler/native_engine.py``); it builds into its own library too
(:func:`load_engine`), with the same flags: ``-O3`` and never
``-ffast-math``, since the engine's occupancy floats must round as
CPython's do.

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
import logging
import os
import subprocess
import threading
from collections.abc import Callable
from pathlib import Path

logger = logging.getLogger("distributed_tpu_torch.native")

SOURCE = Path(__file__).resolve().parent / "graphpack.cpp"
TDIGEST_SOURCE = Path(__file__).resolve().parent / "tdigest.cpp"
ENGINE_SOURCE = Path(__file__).resolve().parent / "engine.cpp"
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

_i32 = ctypes.c_int32
_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)
#: the transition engine's entry points (``engine.cpp``'s ``extern "C"``
#: block), as the reference's ``native/__init__.py`` binds them
ENGINE_SIGNATURES = {
    "eng_new": (_vp, ()),
    "eng_free": (None, (_vp,)),
    "eng_params": (None, (_vp, _f64, _f64, _f64, _f64, _f64, _i64, _i32, _i32, _i32)),
    "eng_worker_upsert": (None, (_vp, _i32, _i32, _i32, _i64, _f64, _i32, _i32, _i32, _i32,
                                 ctypes.c_char_p)),
    "eng_worker_close": (None, (_vp, _i32)),
    "eng_prefix_set": (None, (_vp, _i32, _f64)),
    "eng_prefix_get": (_f64, (_vp, _i32)),
    "eng_group_upsert": (None, (_vp, _i32, _i64, _i32, _i32p)),
    "eng_task_sync_bulk": (None, (
        _vp, _i64, _i32p, _u8p, _u8p, _i32p, _i32p,
        _i64p, _i32p, _i32p, _f64p,
        _i64p, _i32p, _u8p,
        _i64p, _i32p,
        _i64p, _i32p,
        _i64p, _i32p,
    )),
    "eng_task_forget": (None, (_vp, _i32)),
    "eng_set_tape": (None, (_vp, _i32p, _i32p, _i32p, _i32p, _f64p, _f64p, _i64)),
    "eng_drain_finished": (_i32, (_vp, _i64, _i32p, _i32p, _i64p, _f64p, _u8p, _i64p)),
    "eng_drain_recs": (_i32, (_vp, _i64, _i32p, _i32p)),
    "eng_tape_len": (_i64, (_vp,)),
    "eng_escape_row": (_i32, (_vp,)),
    "eng_escape_target": (_i32, (_vp,)),
    "eng_escape_why": (_i32, (_vp,)),
    "eng_pending_recs": (_i64, (_vp, _i32p, _i32p, _i64)),
    "eng_touched": (_i64, (_vp, _i32p, _f64p, _i64)),
    "eng_total_occupancy": (_f64, (_vp,)),
    "eng_transitions": (_i64, (_vp,)),
    "eng_escapes": (_i64, (_vp,)),
    "eng_escape_count": (_i64, (_vp, _i32)),
    "eng_counts": (None, (_vp, _i64p)),
    "eng_replica_add": (None, (_vp, _i32, _i32)),
    "eng_replica_remove": (None, (_vp, _i32, _i32)),
    "eng_task_nbytes": (None, (_vp, _i32, _i64)),
    "eng_task_who_wants": (None, (_vp, _i32, _i32)),
    "eng_task_read": (None, (_vp, _i32, _i64p)),
    "eng_worker_read": (None, (_vp, _i32, _f64p, _i64p)),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tdigest_lib: ctypes.CDLL | None = None
_engine_lib: ctypes.CDLL | None = None


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


def load_engine(build: bool = True) -> ctypes.CDLL | None:
    """The transition engine's library.  ``build=True`` builds it at first
    use and raises ``RuntimeError`` when it cannot be built;
    ``build=False`` never compiles: it loads the library if a build for
    the current source and flags exists, and returns ``None`` otherwise."""
    global _engine_lib
    with _lock:
        if _engine_lib is not None:
            return _engine_lib
        out = library_path(ENGINE_SOURCE, "libdtpu_engine")
        if not out.exists():
            if not build:
                return None
            _compile(out, ENGINE_SOURCE)
        _engine_lib = _bind(ctypes.CDLL(str(out)), ENGINE_SIGNATURES)
        return _engine_lib


def prebuild_async(on_ready: Callable[[], None] | None = None) -> None:
    """Build the transition engine's library on a daemon thread (the
    scheduler server calls this at start so the first flood never waits
    for g++ on the event loop).  ``on_ready`` fires IN THE BUILD THREAD
    once the library is loaded; callers on an event loop trampoline with
    ``call_soon_threadsafe``.  A build that fails is logged, and
    ``on_ready`` is not called: the state then runs the python oracle, and
    ``state.native`` stays None, which a run reads to say which engine ran.

    The reference's ``prebuild_async`` (``native/__init__.py:98``) builds
    its one host library; the port's engine has a library of its own."""

    def run() -> None:
        try:
            load_engine(build=True)
        except Exception:
            logger.exception("native engine build failed")
            return
        if on_ready is not None:
            try:
                on_ready()
            except Exception:
                logger.exception("native prebuild on_ready callback failed")

    threading.Thread(target=run, name="dtpu-native-build", daemon=True).start()


_CTYPES = {"int32": ctypes.c_int32, "float32": ctypes.c_float, "int8": ctypes.c_int8}


def as_ptr(arr):
    """A ctypes pointer to a contiguous int32, float32 or int8 numpy
    array, which the caller keeps alive for the length of the call."""
    if not arr.flags.c_contiguous or arr.dtype.name not in _CTYPES:
        raise ValueError(f"native calls take contiguous {sorted(_CTYPES)} arrays, "
                         f"got {arr.dtype} (contiguous {arr.flags.c_contiguous})")
    return arr.ctypes.data_as(ctypes.POINTER(_CTYPES[arr.dtype.name]))
