"""Typed views of cluster-introspection payloads (reference objects.py).

``Scheduler.identity`` and the dashboard JSON API return plain dicts on
the wire; these TypedDicts are the documented shape — tools (widgets,
deploy reconcilers, tests) key off them instead of guessing fields.
"""

from __future__ import annotations

from typing import Any, TypedDict


class WorkerInfo(TypedDict, total=False):
    """One worker row inside ``SchedulerInfo['workers']``."""

    name: Any
    nthreads: int
    memory_limit: int
    status: str


class SchedulerInfo(TypedDict, total=False):
    """Shape of ``Scheduler.identity()`` (reference objects.py)."""

    type: str
    id: str
    address: str
    dashboard: str | None
    workers: dict[str, WorkerInfo]
