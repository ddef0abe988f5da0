"""The reference's native library for the port's tests, built once a run
and never in place.

``distributed_tpu.native.load()`` runs ``g++ -o`` straight into
``distributed_tpu/native/_dtpu_native.so`` and remembers a failure for the
rest of the process (``distributed_tpu/native/__init__.py:79-97,127-142``).
Under ``pytest -n 6`` on a checkout with no library built, several workers
build at once, and a worker that loads while another one writes gets a
short file: its load fails for good, and so does every test there that
needs the reference's native engine or t-digest (reproduced with six
processes calling ``native.load()`` at one instant: one of three trials
lost a process).

``ref_native_lib`` below, imported into a port test module, is an autouse
fixture of that module: under an exclusive file lock it builds the
reference's own sources with the reference's own flags into
``build/ref_native/`` (a temporary file, then ``os.replace``), points the
reference's loader at that copy and loads it.  The reference's tests keep
their own in-place build.
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import os
import subprocess
from pathlib import Path

import pytest

from distributed_tpu import native as ref_native

BUILD = Path(__file__).resolve().parents[1] / "build" / "ref_native"


def _library() -> Path:
    """The copy for the reference's current sources and flags."""
    h = hashlib.sha256(" ".join(ref_native._FLAGS).encode())
    for src in ref_native._SOURCES:
        h.update(Path(src).read_bytes())
    return BUILD / f"_dtpu_native-{h.hexdigest()[:16]}.so"


def load_reference_native():
    """Load the reference's native library from a private copy built under
    a file lock; returns the library.  A library already loaded in this
    process is kept."""
    if ref_native._lib is not None:
        return ref_native._lib
    BUILD.mkdir(parents=True, exist_ok=True)
    lib = _library()
    info = Path(f"{lib}.buildinfo")
    with open(BUILD / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            tmp = lib.with_suffix(f".tmp{os.getpid()}")
            subprocess.run(["g++", *ref_native._FLAGS, *ref_native._SOURCES, "-o", str(tmp)],
                           check=True, capture_output=True, timeout=300)
            os.replace(tmp, lib)
        info.write_text(json.dumps(ref_native._build_spec()))
    saved = ref_native._LIB_PATH, ref_native._BUILDINFO_PATH
    ref_native._LIB_PATH, ref_native._BUILDINFO_PATH = str(lib), str(info)
    ref_native._build_failed = False  # a failed in-place build earlier in this process
    try:
        loaded = ref_native.load()
    finally:
        ref_native._LIB_PATH, ref_native._BUILDINFO_PATH = saved
    assert loaded is not None, f"the reference's native library did not load from {lib}"
    return loaded


@pytest.fixture(autouse=True, scope="module")
def ref_native_lib():
    return load_reference_native()
