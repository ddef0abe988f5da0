"""PyTorch + CUDA port of ``distributed_tpu`` for NVIDIA Hopper: its device
paths, the sans-io control plane that drives them (the scheduler
engine, the worker state machine and the simulator), and the asyncio
``Scheduler``, ``Worker`` and ``Client`` around it, on a comm and a wire
that need no msgpack.

The JAX package stays the reference; this package sits beside it, keeps
the reference's module names (``ops/leveled.py``, ``ops/flash.py``) and
imports nothing from it.  Every entry point takes ``device=None``, which
means the CUDA device and raises when none is present; only an explicit
``device="cpu"`` runs the plain PyTorch versions of the kernels.

Hand-written kernels live under ``ops/csrc`` and are built with ``nvcc``
at first use (``ops/_build.py``).

The servers, the client, the clusters, the coordination primitives and
the plugin classes are lazy exports, as in the reference
(``distributed_tpu/__init__.py``), without ``SSHCluster`` and
``SubprocessCluster``, which are not ported yet.
"""

from distributed_tpu_torch._device import resolve_device

__version__ = "0.1.0"

__all__ = ["__version__", "resolve_device"]


def __getattr__(name: str):
    # Lazy re-exports so `import distributed_tpu_torch` stays light and cycle-free.
    if name in ("Client", "Future", "as_completed", "wait", "fire_and_forget"):
        from distributed_tpu_torch.client import client as _c

        return getattr(_c, name)
    if name == "Scheduler":
        from distributed_tpu_torch.scheduler.server import Scheduler

        return Scheduler
    if name == "Worker":
        from distributed_tpu_torch.worker.server import Worker

        return Worker
    if name == "Nanny":
        from distributed_tpu_torch.worker.nanny import Nanny

        return Nanny
    if name == "LocalCluster":
        from distributed_tpu_torch.deploy.local import LocalCluster

        return LocalCluster
    if name in ("SpecCluster", "Adaptive", "Cluster"):
        from distributed_tpu_torch.deploy import spec as _spec

        return getattr(_spec, name)
    if name in ("Semaphore", "Lock", "MultiLock", "Event", "Queue", "Variable", "Pub", "Sub"):
        from distributed_tpu_torch import coordination as _coord

        return getattr(_coord, name)
    if name == "Actor":
        from distributed_tpu_torch.client.actor import Actor

        return Actor
    if name in ("SchedulerPlugin", "WorkerPlugin", "NannyPlugin"):
        from distributed_tpu_torch.diagnostics import plugin as _p

        return getattr(_p, name)
    if name in ("progress", "progress_sync"):
        from distributed_tpu_torch.diagnostics import progressbar as _pb

        return getattr(_pb, name)
    raise AttributeError(f"module 'distributed_tpu_torch' has no attribute {name!r}")


_LAZY = (
    "Client", "Future", "as_completed", "wait", "fire_and_forget",
    "Scheduler", "Worker", "Nanny", "LocalCluster", "SpecCluster",
    "Adaptive", "Cluster", "Semaphore", "Lock", "MultiLock", "Event",
    "Queue", "Variable", "Pub", "Sub", "Actor", "SchedulerPlugin",
    "WorkerPlugin", "NannyPlugin", "progress", "progress_sync",
)


def __dir__() -> list[str]:
    # surface the lazy exports to dir()/tab-completion
    return sorted(set(globals()) | set(_LAZY))
