"""Event stream: live task-completion events for remote consumers
(reference diagnostics/eventstream.py:12).

The reference's ``EventStream`` plugin pushes one message per finished
task onto a comm that a client obtained via the ``eventstream`` handler.
Here the same role rides the structured-events plane that already spans
scheduler -> clients: the plugin publishes each completion onto the
``task-events`` topic, and any client follows along with
``Client.subscribe_topic("task-events", cb)`` — no dedicated comm, and
late subscribers still see the ring-buffered tail via
``Client.get_events``.
"""

from __future__ import annotations

from typing import Any

from distributed_tpu_torch.utils.misc import key_split


class EventStreamPlugin:
    """Publish per-task lifecycle events onto the 'task-events' topic."""

    name = "eventstream"
    topic = "task-events"

    def __init__(self, scheduler: Any):
        self.scheduler = scheduler
        scheduler.state.plugins[self.name] = self

    def transition(self, key: str, start: str, finish: str, *args: Any,
                   **kwargs: Any) -> None:
        if finish not in ("memory", "erred") or start != "processing":
            return
        self.scheduler.state.log_event(self.topic, {
            "action": "task-finished" if finish == "memory" else "task-erred",
            "key": key,
            "name": key_split(key),
            "worker": kwargs.get("worker"),
            "nbytes": kwargs.get("nbytes"),
        })
