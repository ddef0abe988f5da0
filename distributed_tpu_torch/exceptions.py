"""Framework exceptions (reference: distributed/exceptions.py, core.py, scheduler.py)."""

from __future__ import annotations


class Reschedule(Exception):
    """Raise inside a task to ask the scheduler to reschedule it elsewhere
    (reference exceptions.py Reschedule)."""


class KilledWorker(Exception):
    """Task failed because its workers died ``allowed-failures`` times
    (reference scheduler.py:8776)."""

    def __init__(self, task: str, last_worker: str, allowed_failures: int):
        super().__init__(task, last_worker, allowed_failures)
        self.task = task
        self.last_worker = last_worker
        self.allowed_failures = allowed_failures

    def __str__(self) -> str:
        return (
            f"Attempted to run task {self.task!r} on {self.allowed_failures + 1} "
            f"different workers, but all those workers died while running it. "
            f"The last worker that attempt to run the task was {self.last_worker}."
        )


class P2PShuffleError(RuntimeError):
    """A P2P shuffle exhausted its restart budget (reference
    shuffle/_exceptions.py P2PConsistencyError/ShuffleClosedError role):
    raised to clients waiting on the shuffle's output tasks."""


class CommClosedError(IOError):
    """The communication channel closed (reference comm/core.py:25)."""


class FatalCommClosedError(CommClosedError):
    """Unrecoverable comm failure — do not retry."""


class RPCError(Exception):
    """Remote handler raised; carries the remote traceback text."""

    def __init__(self, message: str, remote_traceback: str = ""):
        super().__init__(message)
        self.remote_traceback = remote_traceback


class SchedulerClosedError(RuntimeError):
    pass


class WorkerClosedError(RuntimeError):
    pass


class InvalidTransition(Exception):
    """A (start, finish) pair with no handler was requested
    (reference worker_state_machine.py:114)."""

    def __init__(self, key: str, start: str, finish: str, story: list | None = None):
        super().__init__(key, start, finish)
        self.key = key
        self.start = start
        self.finish = finish
        self.story = story or []

    def __str__(self) -> str:
        return f"InvalidTransition: {self.key!r} {self.start} -> {self.finish}"


class InvalidTaskState(Exception):
    """validate_state found a broken invariant (reference wsm.py:158)."""


class TransitionCounterMaxExceeded(InvalidTransition):
    """Transition livelock guard tripped (reference scheduler.py:1667)."""


class NoValidWorkerError(Exception):
    """Task restrictions can never be satisfied."""

    def __init__(self, task: str, host_restrictions=None, worker_restrictions=None,
                 resource_restrictions=None):
        super().__init__(task)
        self.task = task
        self.host_restrictions = host_restrictions
        self.worker_restrictions = worker_restrictions
        self.resource_restrictions = resource_restrictions


class NoSchedulerError(RuntimeError):
    pass
