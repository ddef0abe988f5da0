"""Task stream: per-task compute rectangles (reference diagnostics/task_stream.py:16).

A scheduler plugin recording (key, worker, startstops, duration) for every
processing->memory transition; backs ``Client.get_task_stream`` and
``performance_report``.
"""

from __future__ import annotations

from collections import deque
from typing import Any

from distributed_tpu_torch.utils.misc import key_split


class TaskStreamPlugin:
    name = "task-stream"

    def __init__(self, scheduler: Any, maxlen: int = 100_000):
        self.scheduler = scheduler
        self.buffer: deque = deque(maxlen=maxlen)
        self.index = 0
        scheduler.state.plugins[self.name] = self

    # tape-safe (scheduler/native_engine.py): this hook reads only its
    # arguments, row-current task state and plugin-private structures,
    # never WorkerState.occupancy — so the native engine's applier may
    # replay it per tape row in stream order (docs/native_engine.md)
    tape_safe = True

    def transition(self, key: str, start: str, finish: str, *args: Any,
                   **kwargs: Any) -> None:
        if start == "processing" and finish == "memory":
            startstops = kwargs.get("startstops") or ()
            self.buffer.append(
                {
                    "key": key,
                    "name": key_split(key),
                    "worker": kwargs.get("worker"),
                    "startstops": list(startstops),
                    "nbytes": kwargs.get("nbytes"),
                    # causal join key against /trace and the flight
                    # recorder: the stimulus that produced this rectangle
                    "stimulus_id": kwargs.get("stimulus_id", ""),
                }
            )
            self.index += 1
        elif start == "processing" and finish == "erred":
            self.buffer.append(
                {
                    "key": key,
                    "name": key_split(key),
                    "worker": kwargs.get("worker"),
                    "startstops": [],
                    "error": True,
                    "stimulus_id": kwargs.get("stimulus_id", ""),
                }
            )
            self.index += 1

    def collect(self, start: float | None = None, count: int | None = None) -> list:
        out = list(self.buffer)
        if start is not None:
            out = [
                rec for rec in out
                # records without timing info (errors) always pass
                if not rec["startstops"]
                or any(ss.get("stop", 0) >= start for ss in rec["startstops"])
            ]
        if count is not None:
            out = out[-count:]
        return out
