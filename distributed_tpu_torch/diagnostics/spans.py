"""Spans: tag workloads and aggregate their task statistics
(reference spans.py).

``span("workflow")`` on the client annotates every task submitted inside
the context (reference spans.py:31 does it via dask annotations); the
scheduler-side ``SpansSchedulerExtension`` builds a tree of Span records
aggregating task states, compute time, and bytes as transitions flow
through the plugin hook (reference SpansSchedulerExtension :450,483).
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import uuid
from collections import defaultdict, deque
from typing import TYPE_CHECKING, Any, Iterator

from distributed_tpu_torch.utils.misc import time

if TYPE_CHECKING:
    from distributed_tpu_torch.scheduler.server import Scheduler

_current_span: contextvars.ContextVar[tuple[str, ...] | None] = (
    contextvars.ContextVar("dtpu_span", default=None)
)


@contextlib.contextmanager
def span(*names: str) -> Iterator[str]:
    """Tag tasks submitted in this context (reference spans.py:31)."""
    parent = _current_span.get() or ()
    full = parent + names
    token = _current_span.set(full)
    try:
        yield "/".join(full)
    finally:
        _current_span.reset(token)


def current_span() -> tuple[str, ...] | None:
    return _current_span.get()


class Span:
    """Aggregated stats for one span node (reference spans.py:74)."""

    __slots__ = ("id", "name", "parent", "children", "states", "n_tasks",
                 "compute_seconds", "nbytes", "start", "stop", "activity",
                 "recent_stimuli")

    def __init__(self, name: tuple[str, ...], parent: "Span | None" = None):
        self.id = f"span-{uuid.uuid4().hex[:12]}"
        self.name = name
        self.parent = parent
        self.children: list[Span] = []
        self.states: defaultdict[str, int] = defaultdict(int)
        self.n_tasks = 0
        self.compute_seconds = 0.0
        self.nbytes = 0
        self.start = 0.0
        self.stop = 0.0
        # fine performance metrics: (prefix, label, unit) -> total
        # (reference spans.py cumulative_worker_metrics)
        self.activity: defaultdict[tuple[str, str, str], float] = defaultdict(float)
        # newest stimulus ids whose transitions fed this span (bounded):
        # the causal join key against /trace and the flight recorder —
        # a span's fine-metric rows can be correlated with the engine
        # passes that scheduled its tasks
        self.recent_stimuli: deque[str] = deque(maxlen=32)

    def traverse(self) -> "Iterator[Span]":
        """This span and every descendant, depth-first (reference
        spans.py:74 Span.traverse_spans)."""
        yield self
        for child in self.children:
            yield from child.traverse()

    def cumulative(self) -> dict:
        """Aggregates over the WHOLE subtree — nested spans roll up to
        any depth (reference spans.py cumulative properties: a parent
        span answers for everything submitted under it, not just tasks
        annotated with its exact name)."""
        states: defaultdict[str, int] = defaultdict(int)
        activity: defaultdict[tuple[str, str, str], float] = defaultdict(
            float
        )
        n_tasks = 0
        compute = 0.0
        nbytes = 0
        start, stop = self.start, self.stop
        for sp in self.traverse():
            n_tasks += sp.n_tasks
            compute += sp.compute_seconds
            nbytes += sp.nbytes
            for k, v in sp.states.items():
                states[k] += v
            for k, v in sp.activity.items():
                activity[k] += v
            if sp.start and (not start or sp.start < start):
                start = sp.start
            if sp.stop > stop:
                stop = sp.stop
        return {
            "n_tasks": n_tasks,
            "states": dict(states),
            "compute_seconds": compute,
            "nbytes": nbytes,
            "start": start,
            "stop": stop,
            "activity": {"|".join(k): v for k, v in activity.items()},
        }

    def to_dict(self) -> dict:
        # bottom-up: build children first and fold their ALREADY-rolled
        # cumulative dicts into this node's, so serializing a tree is
        # O(N) instead of re-traversing every subtree per ancestor
        children = [c.to_dict() for c in self.children]
        cum = {
            "n_tasks": self.n_tasks,
            "states": dict(self.states),
            "compute_seconds": self.compute_seconds,
            "nbytes": self.nbytes,
            "start": self.start,
            "stop": self.stop,
            "activity": {
                "|".join(k): v for k, v in self.activity.items()
            },
        }
        for cd in children:
            cc = cd["cumulative"]
            cum["n_tasks"] += cc["n_tasks"]
            cum["compute_seconds"] += cc["compute_seconds"]
            cum["nbytes"] += cc["nbytes"]
            for k, v in cc["states"].items():
                cum["states"][k] = cum["states"].get(k, 0) + v
            for k, v in cc["activity"].items():
                cum["activity"][k] = cum["activity"].get(k, 0.0) + v
            if cc["start"] and (not cum["start"] or cc["start"] < cum["start"]):
                cum["start"] = cc["start"]
            if cc["stop"] > cum["stop"]:
                cum["stop"] = cc["stop"]
        return {
            "id": self.id,
            "name": list(self.name),
            "n_tasks": self.n_tasks,
            "states": dict(self.states),
            "compute_seconds": self.compute_seconds,
            "nbytes": self.nbytes,
            "start": self.start,
            "stop": self.stop,
            "activity": {
                "|".join(k): v for k, v in self.activity.items()
            },
            "recent_stimuli": list(self.recent_stimuli),
            "cumulative": cum,
            "children": children,
        }


class SpansSchedulerExtension:
    """Builds the span tree from task annotations + transitions
    (reference spans.py:450)."""

    def __init__(self, scheduler: "Scheduler"):
        self.scheduler = scheduler
        self.spans: dict[tuple[str, ...], Span] = {}
        self.by_id: dict[str, Span] = {}
        self.key_span: dict[str, Span] = {}
        # fleet-wide fine metrics, spans or not:
        # (context, span_id, prefix, label, unit) -> total
        # (reference spans.py cumulative_worker_metrics)
        self.cumulative_worker_metrics: defaultdict[tuple, float] = (
            defaultdict(float)
        )
        scheduler.state.plugins["spans"] = self
        scheduler.handlers["get_spans"] = self.get_spans
        scheduler.handlers["get_fine_metrics"] = self.get_fine_metrics

    def _get_or_create(self, name: tuple[str, ...]) -> Span:
        sp = self.spans.get(name)
        if sp is None:
            parent = self._get_or_create(name[:-1]) if len(name) > 1 else None
            sp = self.spans[name] = Span(name, parent)
            self.by_id[sp.id] = sp
            if parent is not None:
                parent.children.append(sp)
        return sp

    def collect_fine_metrics(self, rows: list) -> None:
        """Fold one worker heartbeat's activity samples in
        (reference spans.py SpansSchedulerExtension.heartbeat)."""
        for row in rows:
            try:
                context, span_id, prefix, label, unit, value = row
            except (TypeError, ValueError):
                continue
            self.cumulative_worker_metrics[
                (context, span_id, prefix, label, unit)
            ] += value
            sp = self.by_id.get(span_id)
            if sp is not None:
                sp.activity[(prefix, label, unit)] += value

    async def get_fine_metrics(self) -> dict:
        return {
            "|".join(str(p) for p in k): v
            for k, v in self.cumulative_worker_metrics.items()
        }

    # tape-safe (scheduler/native_engine.py): this hook reads only its
    # arguments, row-current task state and plugin-private structures,
    # never WorkerState.occupancy — so the native engine's applier may
    # replay it per tape row in stream order (docs/native_engine.md)
    tape_safe = True

    def transition(self, key: str, start: str, finish: str, *args: Any,
                   **kwargs: Any) -> None:
        sp = self.key_span.get(key)
        if sp is None:
            ts = self.scheduler.state.tasks.get(key)
            if ts is None or not ts.annotations:
                return
            name = ts.annotations.get("span")
            if not name:
                return
            sp = self._get_or_create(tuple(name))
            self.key_span[key] = sp
            sp.n_tasks += 1
            if not sp.start:
                sp.start = time()
            # stamp the group so compute-task messages carry the span id
            # to workers (fine-metric attribution).  Last association
            # wins: consecutive spans sharing a key prefix (and thus a
            # TaskGroup) each retarget the group at association time —
            # concurrent overlap of two spans on one prefix can still
            # misattribute, which the reference avoids only by splitting
            # TaskGroups per span
            if ts.group is not None:
                ts.group.span_id = sp.id
        sp.states[finish] += 1
        sid = kwargs.get("stimulus_id")
        if sid and (not sp.recent_stimuli or sp.recent_stimuli[-1] != sid):
            sp.recent_stimuli.append(sid)
        if finish == "memory" and start == "processing":
            for ss in kwargs.get("startstops") or ():
                if ss.get("action") == "compute":
                    sp.compute_seconds += ss["stop"] - ss["start"]
            nbytes = kwargs.get("nbytes")
            if nbytes:
                sp.nbytes += nbytes
            sp.stop = time()
        if finish == "forgotten":
            self.key_span.pop(key, None)

    async def get_spans(self) -> list[dict]:
        return [
            sp.to_dict() for name, sp in self.spans.items() if len(name) == 1
        ]
