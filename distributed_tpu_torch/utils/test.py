"""Shared in-process test/bench doubles (reference utils_test.py idiom).

Kept inside the package so the bench harness and the test suite drive
scheduler extensions through ONE stub instead of drifting copies.
"""

from __future__ import annotations


class _Status:
    name = "init"


class StubScheduler:
    """The minimal Scheduler surface the state-machine extensions
    (WorkStealing, ActiveMemoryManagerExtension) need when driven
    synchronously off the event loop: construction-time registries plus
    a message sink.  ``sent`` collects every ``send_all`` payload for
    assertions."""

    def __init__(self, state):
        self.state = state
        self.stream_handlers: dict = {}
        self.periodic_callbacks: dict = {}
        self.sent: list = []
        self.status = _Status()

    def send_all(self, client_msgs, worker_msgs) -> None:
        self.sent.append((client_msgs, worker_msgs))
