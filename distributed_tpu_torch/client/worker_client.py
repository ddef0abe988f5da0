"""Tasks submitting sub-tasks from inside a worker
(reference worker_client.py, worker.py:2799 secede/rejoin).

``secede()`` tells the worker's state machine the current task left its
thread slot (a LongRunningMsg flows to the scheduler, which frees the
occupancy); ``worker_client()`` secedes and yields a Client connected to
the same scheduler, running on its own loop thread so the (synchronous)
task body can drive it with ``client.sync(...)``.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

from distributed_tpu_torch.utils.misc import seq_name


def secede() -> None:
    """Remove the current task from its worker thread slot
    (reference worker.py:2799, threadpoolexecutor.py:70).

    Works from executor-thread task bodies AND from coroutine task
    bodies on the worker's event loop (the key rides a contextvar
    there); only the thread flavor grows the OS pool — a coroutine
    holds no thread."""
    from distributed_tpu_torch.worker.context import (
        get_task_key,
        get_thread_key,
        get_worker,
    )
    from distributed_tpu_torch.worker.state_machine import LongRunningEvent

    worker = get_worker()
    key = get_task_key()
    if key is None:
        raise ValueError("secede() must be called from inside a task")
    event = LongRunningEvent(
        stimulus_id=seq_name("secede"), key=key, compute_duration=0.0
    )
    if get_thread_key() is None:
        # coroutine body: already on the worker's loop
        worker.handle_stimulus(event)
        return
    worker.loop.call_soon_threadsafe(worker.handle_stimulus, event)
    # free the OS thread too: the state machine released the slot, but this
    # thread stays blocked in the task body — grow the pool so another task
    # can actually run (reference threadpoolexecutor.py:70 grows the same way)
    ex = worker.executor
    ex._max_workers += 1
    ex._adjust_thread_count()


def rejoin() -> None:
    """Undo secede()'s pool growth when the seceded section ends
    (reference threadpoolexecutor.py rejoin)."""
    from distributed_tpu_torch.worker.context import get_worker

    worker = get_worker()
    ex = worker.executor
    if ex._max_workers > worker.nthreads:
        ex._max_workers -= 1  # pool shrinks lazily as threads idle out


@contextlib.contextmanager
def worker_client(separate_thread: bool = True) -> Iterator:
    """Context manager yielding a Client usable from inside a task
    (reference worker_client.py).

    The task secedes first so the cluster does not deadlock waiting for
    the thread slot it occupies while it, in turn, waits on sub-tasks.
    """
    from distributed_tpu_torch.client.client import Client
    from distributed_tpu_torch.worker.context import get_worker

    worker = get_worker()
    if separate_thread:
        secede()
    client = Client(worker.scheduler_addr, asynchronous=False)
    try:
        yield client
    finally:
        client.__exit__()
        if separate_thread:
            rejoin()
