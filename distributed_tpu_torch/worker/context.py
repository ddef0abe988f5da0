"""Task execution context: ``get_worker()`` from inside a task
(reference worker.py get_worker / thread_state).

The worker sets a thread-local before invoking user code in its executor
(threads are per-worker pools, so the binding is exact even with several
in-process workers), and a contextvar for tasks executed as coroutines on
the event loop.
"""

from __future__ import annotations

import contextvars
import threading
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from distributed_tpu_torch.worker.server import Worker

_thread_state = threading.local()
_async_worker: contextvars.ContextVar = contextvars.ContextVar(
    "dtpu_worker", default=None
)
_async_key: contextvars.ContextVar = contextvars.ContextVar(
    "dtpu_task_key", default=None
)


def set_thread_worker(worker: "Worker", key: str | None = None) -> None:
    _thread_state.worker = worker
    _thread_state.key = key


def get_thread_key() -> str | None:
    return getattr(_thread_state, "key", None)


def set_async_worker(worker: "Worker", key: str | None = None):
    return _async_worker.set(worker), _async_key.set(key)


def reset_async_worker(token) -> None:
    t1, t2 = token
    _async_worker.reset(t1)
    _async_key.reset(t2)


def get_task_key() -> str | None:
    """The key of the currently-executing task: thread-local for executor
    tasks, contextvar for coroutine bodies on the event loop."""
    key = getattr(_thread_state, "key", None)
    if key is not None:
        return key
    return _async_key.get()


def get_worker() -> "Worker":
    """The Worker hosting the currently-executing task."""
    worker = getattr(_thread_state, "worker", None)
    if worker is not None:
        return worker
    worker = _async_worker.get()
    if worker is not None:
        return worker
    raise ValueError("no worker found in this thread/task context")
