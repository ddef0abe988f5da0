"""The worker's device trace on ``torch.profiler``.

The counterpart of ``distributed_tpu/diagnostics/device_profile.py``
(``:44-118``), with its five functions, return dicts and ``status``
values: one trace per process, a second ``start`` an ``error`` status,
``stop`` without a trace an ``error`` status, ``stop`` listing its
``files``.  While a trace runs, the worker runs every task under
``annotate(key)`` (``worker/server.py:1325,1454``), here a
``torch.profiler.record_function`` span, so the kernels a task launches
sit under its key on the timeline.

The worker runs its tasks on a thread pool whose threads exist before the
trace starts.  ``torch.profiler`` records only the thread that started it
unless told otherwise: a span, and the ops and launches inside it, on a
pool thread made before (or after) the start are not in the trace.  So
the trace is taken with ``profile_all_threads``; a torch without that
option gets an ``error`` status from :func:`start`, never a trace that
misses the task threads.  ``stop`` writes ``<logdir>/trace.json``
(``export_chrome_trace``).

A trace taken after the process's first one loses its first kernels (torch
2.11 and CUPTI 12.8 on an H100): their device times fall outside the
trace's capture window though their launches lie inside it, so Kineto
drops them (its log's "Out-of-range" count); a stale mapping of the card's
clock onto the host's, as far as the traces show.  The span lost grows
with the time since the process's first trace (``profile_trace.py``
measures it).  Kernels running under the tracer refresh the
mapping within milliseconds; waiting without kernels does not.  So
:func:`start` prepares the trace, runs small kernels for ``SETTLE_S``, and
only then opens the capture window; and :func:`stop` reads the trace back
and gives an ``error`` status if a kernel launch in it lacks its kernel.

Where the reference degrades quietly, this module does not:
:func:`available` tells whether this torch can trace every thread (it
catches nothing), and :func:`start` raises without a CUDA device unless
the caller asks for the CPU.  :func:`install_device_profile` binds the
five functions onto the reference's module, which the worker reads.
"""

from __future__ import annotations

import contextlib
import functools
import glob
import json
import os
import tempfile
import threading
import time

import torch

from distributed_tpu_torch._device import resolve_device
from distributed_tpu_torch._install import Installed, install

FUNCTIONS = ("available", "active", "start", "stop", "annotate")
TRACE_FILE = "trace.json"

# the runtime and driver calls that launch one kernel each, by their names in a trace
KERNEL_LAUNCHES = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
    "cuLaunchKernel", "cuLaunchKernelEx", "cuLaunchCooperativeKernel",
})

# seconds of kernels under a prepared trace before its capture window opens
# (the module's docstring says why); ``profile_trace.py`` measures a trace's
# lost kernels with and without it
SETTLE_S = 0.02

_lock = threading.Lock()
_active_dir: str | None = None
_profiler = None
_cuda = False  # the running trace records CUDA activity


def all_threads_config():
    """The profiler's experimental config that records every thread of
    the process, or None where this torch has no ``profile_all_threads``."""
    from torch._C._profiler import _ExperimentalConfig

    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:  # the keyword is unknown to this torch
        return None


def available() -> bool:
    """True when this torch's profiler can record every thread."""
    return all_threads_config() is not None


def active() -> bool:
    """True while a trace runs: one module-global read, as the worker asks
    on every task."""
    return _active_dir is not None


def _settle(dev: torch.device) -> None:
    """Small kernels on ``dev`` for ``SETTLE_S``, each waited for, on a
    stream of their own, while the trace is prepared (CUPTI records) but
    its capture window is not yet open, so none of them is in the trace."""
    stream = torch.cuda.Stream(dev)
    with torch.cuda.stream(stream):
        x = torch.zeros(1, device=dev)
        end = time.perf_counter() + SETTLE_S
        while time.perf_counter() < end:
            x.add_(1)
            stream.synchronize()


def start(logdir: str | None = None, device=None) -> dict:
    """Begin the process's device trace: ``{"status": "OK", "logdir": ...}``,
    or an ``error`` status when a trace already runs, when this torch
    cannot record every thread, or when the profiler refuses to start.
    ``device=None`` means CUDA (CPU and CUDA activity are traced) and
    raises without a card; ``device="cpu"`` traces the CPU only."""
    global _active_dir, _profiler, _cuda
    dev = resolve_device(device)
    config = all_threads_config()
    if config is None:
        return {"status": "error",
                "error": f"torch {torch.__version__} has no profile_all_threads: a trace would "
                         "miss the worker's task threads"}
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with _lock:
        if _active_dir is not None:
            return {"status": "error", "error": f"device trace already active in {_active_dir}"}
        logdir = logdir or tempfile.mkdtemp(prefix="dtpu-device-trace-")
        prof = torch.profiler.profile(activities=activities, experimental_config=config)
        try:
            prof.prepare_trace()
            if dev.type == "cuda":
                _settle(dev)
            prof.start_trace()
        except RuntimeError as exc:  # another profiler holds this process
            return {"status": "error", "error": repr(exc)}
        _profiler, _active_dir, _cuda = prof, logdir, dev.type == "cuda"
    return {"status": "OK", "logdir": logdir}


def lost_launches(trace: dict) -> tuple[int, int]:
    """(kernel launches whose kernel the trace lacks, kernel launches) of a
    loaded ``trace.json``: a launch and its kernel share a correlation id."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    kernels = {e["args"].get("correlation") for e in events if e.get("cat") == "kernel"}
    launches = [e["args"].get("correlation") for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and e.get("name") in KERNEL_LAUNCHES]
    return sum(c not in kernels for c in launches), len(launches)


def stop() -> dict:
    """End the trace and write ``<logdir>/trace.json``: ``{"status": "OK",
    "logdir": ..., "files": [...]}``, or an ``error`` status when no trace
    runs.  A CUDA trace is read back: if it holds a kernel launch without
    its kernel, the status is ``error`` (with ``logdir`` and ``files``, the
    file kept), never a trace that quietly lacks kernels."""
    global _active_dir, _profiler, _cuda
    with _lock:
        if _active_dir is None:
            return {"status": "error", "error": "no device trace active"}
        prof, logdir, cuda = _profiler, _active_dir, _cuda
        _profiler = _active_dir = None
        _cuda = False
        prof.stop()
        path = os.path.join(logdir, TRACE_FILE)
        prof.export_chrome_trace(path)
    files = sorted(
        os.path.relpath(p, logdir)
        for p in glob.glob(os.path.join(logdir, "**", "*"), recursive=True)
        if os.path.isfile(p)
    )
    if cuda:
        with open(path) as f:
            lost, launched = lost_launches(json.load(f))
        if lost:
            return {"status": "error", "logdir": logdir, "files": files,
                    "error": f"the trace lacks the kernels of {lost} of its {launched} kernel launches"}
    return {"status": "OK", "logdir": logdir, "files": files}


def annotate(key) -> contextlib.AbstractContextManager:
    """A span named after one task's key while a trace runs; outside a
    trace, a context that does nothing."""
    if _active_dir is None:
        return contextlib.nullcontext()
    return torch.profiler.record_function(str(key))


def install_device_profile(device_profile_module, device=None) -> Installed:
    """Bind this module's five functions onto the reference's
    ``device_profile`` module (the worker calls them through it,
    ``worker/server.py:24,958-959,1325,1454``), ``start`` with ``device``
    (resolved here, so a worker without a card fails at setup).  The
    handle's last ``uninstall()`` stops a trace still running (writing its
    file) and rebinds the module's own functions, the same objects."""
    dev = resolve_device(device)
    ours = {"available": available, "active": active,
            "start": functools.partial(start, device=dev), "stop": stop, "annotate": annotate}

    def apply():
        originals = {name: getattr(device_profile_module, name) for name in FUNCTIONS}
        for name in FUNCTIONS:
            setattr(device_profile_module, name, ours[name])

        def undo():
            if active():
                stop()
            for name, fn in originals.items():
                setattr(device_profile_module, name, fn)

        return undo

    return install("device_profile", device_profile_module, (str(dev),), apply)
