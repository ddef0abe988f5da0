"""Worker state machine — pure, deterministic, sans-IO.

The data-plane mirror of the reference's ``worker_state_machine.py``: a
``WorkerState`` holds every task the scheduler has told this worker about and
moves it through the states

    released -> waiting -> {fetch -> flight -> memory | missing}
                        -> {ready | constrained} -> executing -> memory
                                                -> long-running
    (any) -> cancelled/resumed -> released/forgotten, error, rescheduled

via ``handle_stimulus(event) -> [Instructions]`` (reference wsm.py:1330):
events are frozen dataclasses fed by the networked shell; instructions are
what the shell must do (run a task, gather dependencies from a peer, send a
message to the scheduler).  No asyncio, no sockets, no clocks — which makes
every distributed race deterministically reproducible in tests (reference
test strategy, SURVEY.md §4 tier 1).

Scheduling-within-worker mirrors the reference:
- ``ready``/``constrained`` priority heaps; ``_ensure_computing``
  (wsm.py:1726) fills ``nthreads`` slots;
- per-peer ``data_needed`` heaps; ``_ensure_communicating`` (wsm.py:1531)
  batches fetches <= ``transfer.message-bytes-limit`` per peer and
  <= ``connections.incoming`` concurrent peers, skipping busy/in-flight
  peers (wsm.py:1600).

The port's copy of ``distributed_tpu/worker/state_machine.py``, line for
line but for one seam: ``stimulus_log`` keeps each event without the
values it carries (:func:`_loggable`: an ``ExecuteSuccessEvent``'s
``value``, the ``data`` of a ``GatherDepSuccessEvent`` or an
``UpdateDataEvent`` with its keys kept), as the upstream project's
``to_loggable`` does.  The reference logs the events whole, so its last
10,000 results stay alive after a key is spilled or released; on the card
that would keep a spilled CUDA tensor's device memory.
"""

from __future__ import annotations

import functools
import logging
import random
from collections import defaultdict, deque
from dataclasses import dataclass, field, replace
from typing import Any, Callable

from distributed_tpu_torch import config
from distributed_tpu_torch.diagnostics.census import build_worker_census
from distributed_tpu_torch.diagnostics.selfprofile import WallBudget
from distributed_tpu_torch.exceptions import InvalidTaskState, InvalidTransition
from distributed_tpu_torch.tracing import FlightRecorder
from distributed_tpu_torch.utils import HeapSet, OrderedSet

logger = logging.getLogger("distributed_tpu_torch.worker.state")

Key = str

TASK_STATES = (
    "released",
    "waiting",
    "fetch",
    "flight",
    "missing",
    "ready",
    "constrained",
    "executing",
    "long-running",
    "memory",
    "cancelled",
    "resumed",
    "rescheduled",
    "error",
    "forgotten",
)

READY_STATES = frozenset({"ready", "constrained"})
PROCESSING_STATES = frozenset({"waiting", "ready", "constrained", "executing", "long-running"})
FETCH_STATES = frozenset({"fetch", "flight"})


class WTaskState:
    """Worker-side task record (reference wsm.py:TaskState)."""

    __slots__ = (
        "key",
        "run_spec",
        "state",
        "previous",
        "next",
        "priority",
        "dependencies",
        "dependents",
        "waiting_for_data",
        "waiters",
        "who_has",
        "coming_from",
        "nbytes",
        "duration",
        "resource_restrictions",
        "exception",
        "traceback",
        "exception_text",
        "traceback_text",
        "actor",
        "done",
        "attempt",
        "span_id",
        "annotations",
        "stimulus_id",
        "_hash",
    )

    def __init__(self, key: Key, run_spec: Any = None, priority: tuple = ()):
        self.key = key
        self._hash = hash(key)
        self.run_spec = run_spec
        self.state = "released"
        self.previous: str | None = None  # for cancelled/resumed
        self.next: str | None = None
        self.priority = priority
        # insertion-ordered (utils.collections.OrderedSet), NOT
        # hash-ordered sets: the worker machine iterates these to build
        # recommendations, fetch queues (data_needed row creation) and
        # instructions, so iteration order is decision order — same
        # contract as the scheduler's relation fields
        self.dependencies: OrderedSet[WTaskState] = OrderedSet()
        self.dependents: OrderedSet[WTaskState] = OrderedSet()
        self.waiting_for_data: OrderedSet[WTaskState] = OrderedSet()
        self.waiters: OrderedSet[WTaskState] = OrderedSet()
        self.who_has: OrderedSet[str] = OrderedSet()
        self.coming_from: str | None = None
        self.nbytes = 0
        self.duration: float = -1
        self.resource_restrictions: dict[str, float] = {}
        self.exception: Any = None
        self.traceback: Any = None
        self.exception_text = ""
        self.traceback_text = ""
        self.actor = False
        self.done = False
        self.attempt = 0
        self.span_id: str | None = None
        self.annotations: dict = {}
        self.stimulus_id = ""

    def __repr__(self) -> str:
        return f"<WTaskState {self.key!r} {self.state}>"

    def __hash__(self) -> int:
        return self._hash


# --------------------------------------------------------------------- events


@dataclass(frozen=True)
class StateMachineEvent:
    stimulus_id: str

    @classmethod
    def dummy(cls, stimulus_id: str = "dummy", **kwargs: Any) -> "StateMachineEvent":
        return cls(stimulus_id=stimulus_id, **kwargs)


@dataclass(frozen=True)
class ComputeTaskEvent(StateMachineEvent):
    """Scheduler asks this worker to run a task (reference wsm.py:738)."""

    key: Key
    run_spec: Any = None
    priority: tuple = ()
    who_has: dict[Key, list[str]] = field(default_factory=dict)
    nbytes: dict[Key, int] = field(default_factory=dict)
    duration: float = 0.5
    resource_restrictions: dict[str, float] = field(default_factory=dict)
    actor: bool = False
    annotations: dict = field(default_factory=dict)
    span_id: str | None = None

    @classmethod
    def dummy(cls, key: Key = "x", stimulus_id: str = "dummy", **kwargs: Any):
        kwargs.setdefault("run_spec", _DummySpec())
        return cls(stimulus_id=stimulus_id, key=key, **kwargs)


class _DummySpec:
    def substitute(self, data):
        return (lambda: None), (), {}


@dataclass(frozen=True)
class ExecuteSuccessEvent(StateMachineEvent):
    key: Key = ""
    value: Any = None
    start: float = 0.0
    stop: float = 0.0
    nbytes: int = 0
    type: str | None = None


@dataclass(frozen=True)
class ExecuteFailureEvent(StateMachineEvent):
    key: Key = ""
    exception: Any = None
    traceback: Any = None
    exception_text: str = ""
    traceback_text: str = ""
    start: float = 0.0
    stop: float = 0.0


@dataclass(frozen=True)
class RescheduleEvent(StateMachineEvent):
    key: Key = ""


@dataclass(frozen=True)
class LongRunningEvent(StateMachineEvent):
    """Task called secede() (reference worker.py:2799)."""

    key: Key = ""
    compute_duration: float = 0.0


@dataclass(frozen=True)
class GatherDepSuccessEvent(StateMachineEvent):
    worker: str = ""
    data: dict[Key, Any] = field(default_factory=dict)
    total_nbytes: int = 0


@dataclass(frozen=True)
class GatherDepBusyEvent(StateMachineEvent):
    worker: str = ""
    keys: tuple = ()


@dataclass(frozen=True)
class GatherDepNetworkFailureEvent(StateMachineEvent):
    worker: str = ""
    keys: tuple = ()


@dataclass(frozen=True)
class GatherDepFailureEvent(StateMachineEvent):
    """Deserialization or other local error while receiving."""

    worker: str = ""
    keys: tuple = ()
    exception: Any = None
    traceback: Any = None


@dataclass(frozen=True)
class FreeKeysEvent(StateMachineEvent):
    keys: tuple = ()


@dataclass(frozen=True)
class RemoveReplicasEvent(StateMachineEvent):
    keys: tuple = ()


@dataclass(frozen=True)
class AcquireReplicasEvent(StateMachineEvent):
    """AMM asks this worker to fetch replicas (reference wsm.py)."""

    who_has: dict[Key, list[str]] = field(default_factory=dict)
    nbytes: dict[Key, int] = field(default_factory=dict)


@dataclass(frozen=True)
class StealRequestEvent(StateMachineEvent):
    key: Key = ""


@dataclass(frozen=True)
class UpdateDataEvent(StateMachineEvent):
    """Client scattered data directly to this worker.

    ``report=False`` suppresses the add-keys message — used by scatter,
    where the scheduler registers the replicas itself and an early
    add-keys would race with that registration (reference worker.py
    update_data(report=False)).
    """

    data: dict[Key, Any] = field(default_factory=dict)
    report: bool = True


@dataclass(frozen=True)
class PauseEvent(StateMachineEvent):
    pass


@dataclass(frozen=True)
class UnpauseEvent(StateMachineEvent):
    pass


@dataclass(frozen=True)
class RetryBusyWorkerEvent(StateMachineEvent):
    worker: str = ""


@dataclass(frozen=True)
class FindMissingEvent(StateMachineEvent):
    pass


def _loggable(event: StateMachineEvent) -> StateMachineEvent:
    """``event`` as the stimulus log keeps it: without the values it
    carries, so the log holds no result alive."""
    kind = type(event)
    if kind is ExecuteSuccessEvent and event.value is not None:
        return replace(event, value=None)
    if (kind is GatherDepSuccessEvent or kind is UpdateDataEvent) and event.data:
        return replace(event, data=dict.fromkeys(event.data))
    return event


@dataclass(frozen=True)
class RefreshWhoHasEvent(StateMachineEvent):
    who_has: dict[Key, list[str]] = field(default_factory=dict)


# --------------------------------------------------------------- instructions


@dataclass(frozen=True)
class Instruction:
    stimulus_id: str


@dataclass(frozen=True)
class Execute(Instruction):
    key: Key = ""


@dataclass(frozen=True)
class GatherDep(Instruction):
    worker: str = ""
    to_gather: tuple = ()
    total_nbytes: int = 0


@dataclass(frozen=True)
class RetryBusyWorkerLater(Instruction):
    worker: str = ""


@dataclass(frozen=True)
class SendMessageToScheduler(Instruction):
    pass

    def to_dict(self) -> dict:
        d = {
            k: getattr(self, k)
            for k in self.__dataclass_fields__
        }
        d["op"] = self.op  # type: ignore[attr-defined]
        return d


@dataclass(frozen=True)
class TaskFinishedMsg(SendMessageToScheduler):
    op = "task-finished"
    key: Key = ""
    nbytes: int = 0
    typename: str | None = None
    startstops: tuple = ()
    metadata: dict = field(default_factory=dict)


@dataclass(frozen=True)
class TaskErredMsg(SendMessageToScheduler):
    op = "task-erred"
    key: Key = ""
    exception: Any = None
    traceback: Any = None
    exception_text: str = ""
    traceback_text: str = ""
    startstops: tuple = ()


@dataclass(frozen=True)
class ReleaseWorkerDataMsg(SendMessageToScheduler):
    op = "release-worker-data"
    key: Key = ""


@dataclass(frozen=True)
class RescheduleMsg(SendMessageToScheduler):
    op = "reschedule"
    key: Key = ""


@dataclass(frozen=True)
class LongRunningMsg(SendMessageToScheduler):
    op = "long-running"
    key: Key = ""
    compute_duration: float = 0.0


@dataclass(frozen=True)
class AddKeysMsg(SendMessageToScheduler):
    op = "add-keys"
    keys: tuple = ()


@dataclass(frozen=True)
class StealResponseMsg(SendMessageToScheduler):
    op = "steal-response"
    key: Key = ""
    state: str | None = None


@dataclass(frozen=True)
class MissingDataMsg(SendMessageToScheduler):
    op = "missing-data"
    key: Key = ""
    errant_worker: str = ""


@dataclass(frozen=True)
class RequestRefreshWhoHasMsg(SendMessageToScheduler):
    op = "request-refresh-who-has"
    keys: tuple = ()


Instructions = list  # list[Instruction]
Recs = dict  # dict[WTaskState, str]


class WorkerState:
    """Pure worker state (reference worker_state_machine.py:1060)."""

    def __init__(
        self,
        *,
        nthreads: int = 1,
        address: str = "",
        data: dict | None = None,
        resources: dict[str, float] | None = None,
        validate: bool | None = None,
        transfer_incoming_count_limit: int | None = None,
        transfer_message_bytes_limit: int | None = None,
        execute_pipeline: int = 0,
        execute_pipeline_threshold: float = 0.005,
        clock: Callable[[], float] | None = None,
    ):
        self.address = address
        self.nthreads = nthreads
        # issue up to this many EXTRA Executes beyond nthreads for tasks
        # whose scheduler duration estimate is below the threshold: the
        # server coalesces one instruction batch of tiny tasks into a
        # single executor submission (one thread handoff + one loop
        # wakeup for the whole batch instead of per task).  Unknown
        # prefixes (duration = UNKNOWN 0.5 s) never pipeline, so a slow
        # first-of-its-kind task cannot hide behind the gate.
        self.execute_pipeline = execute_pipeline
        self.execute_pipeline_threshold = execute_pipeline_threshold
        self.data: dict[Key, Any] = data if data is not None else {}
        self.tasks: dict[Key, WTaskState] = {}
        self.ready: HeapSet[WTaskState] = HeapSet(key=lambda ts: ts.priority)
        self.constrained: deque[WTaskState] = deque()
        # insertion-ordered: cancellation/pause sweeps and the census
        # walk these, and missing-dep retries re-enqueue in scan order
        self.executing: OrderedSet[WTaskState] = OrderedSet()
        self.long_running: OrderedSet[WTaskState] = OrderedSet()
        self.in_flight_tasks: OrderedSet[WTaskState] = OrderedSet()
        self.missing_dep_flight: OrderedSet[WTaskState] = OrderedSet()
        # fetch queues: per-peer heap of tasks to pull
        self.data_needed: defaultdict[str, HeapSet[WTaskState]] = defaultdict(
            lambda: HeapSet(key=lambda ts: ts.priority)
        )
        self.in_flight_workers: dict[str, OrderedSet[Key]] = {}
        self.busy_workers: OrderedSet[str] = OrderedSet()
        self.has_what: defaultdict[str, OrderedSet[Key]] = defaultdict(OrderedSet)
        self.actors: dict[Key, Any] = {}
        self.total_resources = dict(resources or {})
        self.available_resources = dict(resources or {})
        self.running = True  # False when paused
        self.transfer_incoming_count = 0
        self.transfer_incoming_bytes = 0
        self.transfer_incoming_count_limit = (
            transfer_incoming_count_limit
            if transfer_incoming_count_limit is not None
            else config.get("worker.connections.incoming")
        )
        self.transfer_message_bytes_limit = (
            transfer_message_bytes_limit
            if transfer_message_bytes_limit is not None
            else config.parse_bytes(config.get("worker.transfer.message-bytes-limit"))
        )
        self.validate = (
            validate if validate is not None else config.get("worker.validate")
        )
        self.nbytes_in_memory = 0
        self.transition_counter = 0
        self.log: deque = deque(maxlen=100_000)
        self.stimulus_log: deque = deque(maxlen=10_000)
        # flight recorder (tracing.py): stimulus batches land here with
        # the same scheduler-minted stimulus ids the scheduler's ring
        # carries, so /trace on both roles joins on one causal id.
        # This machine never reads a clock itself — the injectable
        # ``clock`` (ROADMAP item 1 simulator) only re-stamps its trace
        # ring onto virtual time.
        self.trace = FlightRecorder()
        if clock is not None:
            self.trace.clock = clock
        # wall-budget phase attribution (diagnostics/selfprofile.py):
        # ``wengine.stimulus`` per handle_stimulus batch, plus opt-in
        # ``wengine.scalar-arm:<start>,<finish>`` arms — always REAL
        # monotonic time (python cost, not virtual time), so the
        # injectable clock above deliberately does not re-point it
        self.wall = WallBudget()
        self.WALL_ARMS: bool = bool(
            config.get("scheduler.profile.arm-attribution", False)
        )
        self._arm_phases: dict[tuple[str, str], str] = {}
        self.rng = random.Random(0)  # deterministic (reference wsm.py:1328)
        self.task_counter: defaultdict[str, int] = defaultdict(int)

        self._transitions_table: dict[tuple[str, str], Callable] = {
            ("released", "waiting"): self._transition_released_waiting,
            ("released", "fetch"): self._transition_released_fetch,
            # released_fetch recommends "missing" when the dep has NO
            # known holders (a compute-task/acquire-replicas can name a
            # dep whose replicas just vanished): without this edge that
            # recommendation raised InvalidTransition and killed the
            # stimulus batch (found by the simulator's worker suite)
            ("released", "missing"): self._transition_fetch_missing,
            ("released", "memory"): self._transition_released_memory,
            ("released", "forgotten"): self._transition_released_forgotten,
            ("waiting", "ready"): self._transition_waiting_ready,
            ("waiting", "constrained"): self._transition_waiting_constrained,
            ("waiting", "released"): self._transition_generic_released,
            ("ready", "executing"): self._transition_ready_executing,
            ("ready", "released"): self._transition_generic_released,
            ("constrained", "executing"): self._transition_constrained_executing,
            ("constrained", "released"): self._transition_generic_released,
            ("executing", "memory"): self._transition_executing_memory,
            ("executing", "error"): self._transition_executing_error,
            ("executing", "released"): self._transition_executing_released,
            ("executing", "rescheduled"): self._transition_executing_rescheduled,
            ("executing", "long-running"): self._transition_executing_long_running,
            ("long-running", "memory"): self._transition_executing_memory,
            ("long-running", "error"): self._transition_executing_error,
            ("long-running", "released"): self._transition_executing_released,
            ("long-running", "rescheduled"): self._transition_executing_rescheduled,
            # a fetch/missing/error task re-targeted as a COMPUTE: the
            # compute-task handler wires waiting_for_data BEFORE the
            # transition, and the released fallback would wipe it —
            # released->waiting then sees no pending deps and sends the
            # task to ready with its inputs absent (tripped the ready
            # invariant; found by the simulator's partition chaos
            # scenario, where the recompute of a task whose replica the
            # partition stripped lands on a worker that had it "missing")
            ("missing", "waiting"): self._transition_redirected_waiting,
            ("fetch", "waiting"): self._transition_redirected_waiting,
            ("error", "waiting"): self._transition_redirected_waiting,
            ("fetch", "flight"): self._transition_fetch_flight,
            ("fetch", "released"): self._transition_generic_released,
            ("fetch", "missing"): self._transition_fetch_missing,
            ("flight", "memory"): self._transition_flight_memory,
            ("flight", "fetch"): self._transition_flight_fetch,
            ("flight", "released"): self._transition_flight_released,
            ("flight", "missing"): self._transition_flight_missing,
            # local failure while receiving (deserialization error): a
            # direct edge — the released fallback would park the task in
            # "cancelled" via flight->released (previous="flight" left
            # stale) and then release execution resources the fetch
            # never held on the cancelled->error hop (found by the
            # state-machine lint, rule 9)
            ("flight", "error"): self._transition_flight_error,
            ("missing", "fetch"): self._transition_missing_fetch,
            ("missing", "released"): self._transition_generic_released,
            ("memory", "released"): self._transition_memory_released,
            ("cancelled", "released"): self._transition_cancelled_released,
            ("cancelled", "memory"): self._transition_cancelled_memory,
            ("cancelled", "error"): self._transition_cancelled_error,
            ("cancelled", "rescheduled"): self._transition_cancelled_released,
            ("cancelled", "waiting"): self._transition_cancelled_waiting,
            ("cancelled", "fetch"): self._transition_cancelled_fetch,
            # resumed (cancelled then wanted again) execute ending in
            # Reschedule: nothing was produced — tell the scheduler to
            # re-place it, exactly like an executing task would
            ("resumed", "rescheduled"): self._transition_executing_rescheduled,
            ("resumed", "memory"): self._transition_executing_memory,
            ("resumed", "released"): self._transition_resumed_released,
            ("resumed", "error"): self._transition_executing_error,
            ("resumed", "fetch"): self._transition_resumed_fetch,
            ("resumed", "missing"): self._transition_resumed_missing,
            ("error", "released"): self._transition_generic_released,
            ("rescheduled", "released"): self._transition_generic_released,
        }

        # state census (diagnostics/census.py): typed inventory of every
        # long-lived container above — the scheduler-side census's
        # worker twin (docs/observability.md).  Built LAZILY on first
        # access: a census is ~17 KiB of probe closures, and the
        # simulator instantiates 10,000 of these machines whose
        # censuses are only read at the quiesce gate (or under
        # DTPU_CENSUS_CHECK).
        self._census: Any = None

    @property
    def census(self) -> Any:
        c = self._census
        if c is None:
            c = self._census = build_worker_census(self)
        return c

    # ------------------------------------------------------------- stimulus

    def handle_stimulus(self, *events: StateMachineEvent) -> Instructions:
        """Feed events, return the instructions the shell must execute
        (reference wsm.py:1330).

        The computing/communicating drains run ONCE per event batch, not
        per event: a scheduler stream payload carrying a whole tile of
        compute-task messages must aggregate its missing deps into few
        GatherDep instructions — per-event drains fired a 1-key request
        per message (measured 1.4 keys per gather on the tensordot
        bench, with per-request loop cost dwarfing the payload)."""
        instructions: Instructions = []
        tr = self.trace
        self.wall.push(
            "wengine.stimulus", events[0].stimulus_id if events else ""
        )
        # arm-attribution mode also breaks out the event-handler bodies
        # and ensure drains, so the worker half of sim.profile_run's
        # table names every compiled-core candidate, not only the arms
        arms = self.WALL_ARMS
        wall = self.wall
        try:
            for event in events:
                self.stimulus_log.append(_loggable(event))
                # task-level trace hop (sampled): the payload-boundary batch
                # arrives as one handle_stimulus call, so each event's
                # stimulus id joins the scheduler envelope that carried it
                tr.emit_task("wstim", type(event).__name__, event.stimulus_id)
                handler = getattr(self, "_handle_" + _snake(type(event).__name__))
                if arms:
                    wall.push(
                        self._handler_phase(type(event).__name__),
                        event.stimulus_id,
                    )
                try:
                    recs, instr = handler(event)
                finally:
                    if arms:
                        wall.pop()
                instructions += instr
                instructions += self._transitions(recs, stimulus_id=event.stimulus_id)
            stimulus_id = events[-1].stimulus_id if events else "ensure"
            if arms:
                with wall.phase("wengine.ensure-computing", stimulus_id):
                    instructions += self._ensure_computing(stimulus_id)
                with wall.phase("wengine.ensure-communicating", stimulus_id):
                    instructions += self._ensure_communicating(stimulus_id)
            else:
                instructions += self._ensure_computing(stimulus_id)
                instructions += self._ensure_communicating(stimulus_id)
            if self.validate:
                self.validate_state()
            return instructions
        finally:
            wall.pop()

    # -------------------------------------------------------- event handlers

    def _handle_compute_task(self, ev: ComputeTaskEvent) -> tuple[Recs, Instructions]:
        ts = self.tasks.get(ev.key)
        if ts is None:
            ts = self.tasks[ev.key] = WTaskState(ev.key)
        ts.run_spec = ev.run_spec
        ts.priority = tuple(ev.priority)
        ts.duration = ev.duration
        ts.resource_restrictions = dict(ev.resource_restrictions)
        ts.actor = ev.actor
        ts.annotations = dict(ev.annotations)
        ts.span_id = ev.span_id
        ts.stimulus_id = ev.stimulus_id

        recs: Recs = {}
        if ts.state in ("executing", "long-running", "waiting",
                        "ready", "constrained"):
            # duplicate compute-task: already underway
            return recs, []
        if ts.state == "memory":
            return recs, [
                TaskFinishedMsg(
                    stimulus_id=ev.stimulus_id,
                    key=ts.key,
                    nbytes=ts.nbytes,
                    typename=None,
                    startstops=(),
                )
            ]
        # released / fetch / flight / missing / cancelled / resumed /
        # error: recommend "waiting" — the cancelled/resumed transitions
        # (and the through-released fallback) turn interrupted fetches
        # and executions into resumed-towards-compute
        # (reference wsm.py:2851-2861)

        # wire up dependencies
        for dep_key, workers in ev.who_has.items():
            dts = self.tasks.get(dep_key)
            if dts is None:
                dts = self.tasks[dep_key] = WTaskState(dep_key)
                dts.priority = ts.priority
            # drop has_what rows for peers the fresh view no longer
            # names (e.g. a dead worker): the replacement below would
            # otherwise strand them forever (census-found)
            for w in dts.who_has.difference(workers):
                self._drop_has_what(w, dep_key)
            dts.who_has = OrderedSet(workers)
            dts.nbytes = ev.nbytes.get(dep_key, dts.nbytes)
            ts.dependencies.add(dts)
            dts.dependents.add(ts)
            if dts.state not in ("memory", "flight", "executing", "long-running"):
                if dep_key in self.data:
                    recs[dts] = "memory"
                else:
                    ts.waiting_for_data.add(dts)
                    dts.waiters.add(ts)
                    if dts.state not in FETCH_STATES and dts.state not in (
                        "missing",
                        # locally QUEUED to (re)compute: recommending a
                        # fetch would route ready->released->fetch and
                        # discard the scheduler-assigned local compute —
                        # wait for _put_memory like any local producer
                        "ready", "constrained", "waiting",
                    ):
                        recs[dts] = "fetch"
            elif dts.state in ("flight", "executing", "long-running"):
                # the dep's data isn't here yet in EITHER case: in
                # flight from a peer, or being (re)computed locally — a
                # freed-then-recomputed dep races exactly like a fetch
                # (found by the tcp race suite: the dependent went
                # waiting->ready with the dep still executing and no
                # data, tripping the ready invariant).  If the local
                # execution ERRS instead, the scheduler's erred cascade
                # frees this dependent (it has the dep as processing
                # here, so the task-erred report is never fenced) and
                # generic_released clears waiting_for_data — same
                # resolution as a flight dep whose gather fails.
                ts.waiting_for_data.add(dts)
                dts.waiters.add(ts)
        # sever dependency edges from a previous incarnation that this
        # compute-task no longer names: ``who_has`` carries EVERY
        # current dependency (the target's own replicas included), so
        # an edge absent from it is scheduler-authoritative stale —
        # e.g. a pure-data input forgotten after its last replica
        # vanished, whose recompute proceeds without it.  Left in
        # place, waiting->ready demanded data that could never come
        # (partition chaos + the census-era remove-replicas repair
        # reproduced it deterministically).  Sorted: relation sets are
        # hash-ordered here, and the forget recommendations must land
        # in a process-independent order.
        stale = sorted(
            (d for d in ts.dependencies if d.key not in ev.who_has),
            key=lambda d: d.key,
        )
        for dts in stale:
            ts.dependencies.discard(dts)
            dts.dependents.discard(ts)
            ts.waiting_for_data.discard(dts)
            dts.waiters.discard(ts)
            if not dts.dependents and dts.state == "released":
                recs[dts] = "forgotten"
        recs[ts] = "waiting"
        return recs, []

    def _handle_execute_success(self, ev: ExecuteSuccessEvent) -> tuple[Recs, Instructions]:
        ts = self.tasks.get(ev.key)
        if ts is None:
            return {}, []
        ts.done = True
        if ts.state == "cancelled":
            return {ts: "released"}, []
        ts.nbytes = ev.nbytes
        self.data[ts.key] = ev.value
        return {ts: ("memory", ev)}, []

    def _handle_execute_failure(self, ev: ExecuteFailureEvent) -> tuple[Recs, Instructions]:
        ts = self.tasks.get(ev.key)
        if ts is None:
            return {}, []
        ts.done = True
        if ts.state == "cancelled":
            return {ts: "released"}, []
        return {ts: ("error", ev)}, []

    def _handle_reschedule(self, ev: RescheduleEvent) -> tuple[Recs, Instructions]:
        ts = self.tasks.get(ev.key)
        if ts is None:
            return {}, []
        ts.done = True
        return {ts: "rescheduled"}, []

    def _handle_long_running(self, ev: LongRunningEvent) -> tuple[Recs, Instructions]:
        ts = self.tasks.get(ev.key)
        if ts is None:
            return {}, []
        if ts.state == "executing":
            return {ts: ("long-running", ev)}, []
        if ts.state in ("cancelled", "resumed") and ts.previous == "executing":
            # the cancelled/resumed body is still running and just
            # seceded: free the slot NOW (the whole point of seceding)
            # and remember it as long-running so completion accounting
            # stays right (reference wsm.py sets previous accordingly —
            # dropping the event here re-wedges the worker the shuffle
            # secede fix exists for)
            self.executing.discard(ts)
            self.long_running.add(ts)
            ts.previous = "long-running"
        return {}, []

    def _handle_gather_dep_success(self, ev: GatherDepSuccessEvent) -> tuple[Recs, Instructions]:
        recs: Recs = {}
        instr: Instructions = []
        self._gather_finished(ev.worker)
        received = set(ev.data)
        stored: list[Key] = []
        for key, value in ev.data.items():
            ts = self.tasks.get(key)
            if ts is None or ts.state not in ("flight", "resumed"):
                # unsolicited data (e.g. the fetch was cancelled mid-
                # flight): drop it — and do NOT announce it, or the
                # scheduler would record a phantom replica here that
                # peers then try to fetch forever (livelock)
                if ts is not None and ts.state == "cancelled":
                    recs[ts] = "released"
                continue
            # "resumed": the fetch was cancelled then the key re-requested
            # as a compute — the arrived value satisfies it directly; no
            # Execute exists to complete it otherwise (wedge)
            if ts.state == "resumed":
                self.in_flight_tasks.discard(ts)
                ts.coming_from = None
                # resumed -> memory emits TaskFinishedMsg, which already
                # registers the replica — no AddKeysMsg needed
                self.data[key] = value
                recs[ts] = "memory"
                continue
            self.data[key] = value
            stored.append(key)
            recs[ts] = "memory"
        if stored:
            instr.append(AddKeysMsg(stimulus_id=ev.stimulus_id, keys=tuple(stored)))
        # keys requested but not received: the peer no longer has them.
        # Tell the scheduler (missing-data) so it drops the stale replica
        # from who_has — otherwise refresh-who-has keeps pointing us back
        # at the same errant peer (reference scheduler.py handle_missing_data)
        requested = self.in_flight_workers.pop(ev.worker, set())
        for key in requested - received:
            ts = self.tasks.get(key)
            if ts is None:
                continue
            self.in_flight_tasks.discard(ts)
            ts.coming_from = None
            ts.who_has.discard(ev.worker)
            self._drop_has_what(ev.worker, key)
            instr.append(
                MissingDataMsg(
                    stimulus_id=ev.stimulus_id, key=key, errant_worker=ev.worker
                )
            )
            if ts.state == "flight":
                recs[ts] = "fetch" if ts.who_has else "missing"
            elif ts.state == "cancelled":
                ts.done = True
                recs[ts] = "released"
            elif ts.state == "resumed":
                # the fetch ended empty-handed but the scheduler asked for
                # a compute meanwhile: done=True lets resumed->fetch fall
                # through released->waiting and run it
                ts.done = True
                recs[ts] = "fetch"
        return recs, instr

    def _handle_gather_dep_busy(self, ev: GatherDepBusyEvent) -> tuple[Recs, Instructions]:
        self._gather_finished(ev.worker)
        self.busy_workers.add(ev.worker)
        recs: Recs = {}
        requested = self.in_flight_workers.pop(ev.worker, set())
        for key in requested:
            ts = self.tasks.get(key)
            if ts is None:
                continue
            self.in_flight_tasks.discard(ts)
            ts.coming_from = None
            if ts.state == "flight":
                recs[ts] = "fetch"
            elif ts.state == "cancelled":
                ts.done = True
                recs[ts] = "released"
            elif ts.state == "resumed":
                ts.done = True
                recs[ts] = "fetch"
        return recs, [
            RetryBusyWorkerLater(stimulus_id=ev.stimulus_id, worker=ev.worker)
        ]

    def _handle_gather_dep_network_failure(
        self, ev: GatherDepNetworkFailureEvent
    ) -> tuple[Recs, Instructions]:
        self._gather_finished(ev.worker)
        recs: Recs = {}
        instr: Instructions = []
        requested = self.in_flight_workers.pop(ev.worker, set())
        for key in requested:
            ts = self.tasks.get(key)
            if ts is None:
                continue
            self.in_flight_tasks.discard(ts)
            ts.coming_from = None
            ts.who_has.discard(ev.worker)
            self._drop_has_what(ev.worker, key)
            instr.append(
                MissingDataMsg(
                    stimulus_id=ev.stimulus_id, key=key, errant_worker=ev.worker
                )
            )
            if ts.state == "flight":
                recs[ts] = "fetch" if ts.who_has else "missing"
            elif ts.state == "cancelled":
                ts.done = True
                recs[ts] = "released"
            elif ts.state == "resumed":
                ts.done = True
                recs[ts] = "fetch"
        return recs, instr

    def _handle_gather_dep_failure(self, ev: GatherDepFailureEvent) -> tuple[Recs, Instructions]:
        self._gather_finished(ev.worker)
        recs: Recs = {}
        requested = self.in_flight_workers.pop(ev.worker, set())
        for key in requested:
            ts = self.tasks.get(key)
            if ts is None:
                continue
            self.in_flight_tasks.discard(ts)
            ts.coming_from = None
            ts.exception = ev.exception
            ts.traceback = ev.traceback
            if ts.state == "flight":
                recs[ts] = ("error", ev)
            else:
                recs[ts] = "released"
        return recs, []

    def _handle_free_keys(self, ev: FreeKeysEvent) -> tuple[Recs, Instructions]:
        """Scheduler says these keys are no longer needed (cancellation)."""
        recs: Recs = {}
        for key in ev.keys:
            ts = self.tasks.get(key)
            if ts is not None:
                recs[ts] = "released"
        return recs, []

    def _handle_remove_replicas(self, ev: RemoveReplicasEvent) -> tuple[Recs, Instructions]:
        """AMM drops replicas; only memory tasks without local waiters go."""
        recs: Recs = {}
        instr: Instructions = []
        for key in ev.keys:
            ts = self.tasks.get(key)
            if ts is None:
                continue
            if ts.state == "memory" and not any(
                d.state in PROCESSING_STATES for d in ts.dependents
            ):
                recs[ts] = "released"
                instr.append(ReleaseWorkerDataMsg(stimulus_id=ev.stimulus_id, key=key))
            elif ts.state == "memory":
                instr.append(AddKeysMsg(stimulus_id=ev.stimulus_id, keys=(key,)))
        return recs, instr

    def _handle_acquire_replicas(self, ev: AcquireReplicasEvent) -> tuple[Recs, Instructions]:
        recs: Recs = {}
        for key, workers in ev.who_has.items():
            ts = self.tasks.get(key)
            if ts is None:
                ts = self.tasks[key] = WTaskState(key)
                ts.priority = (1_000_000,)  # replicas fetch at low priority
            for w in ts.who_has.difference(workers):
                self._drop_has_what(w, key)
            ts.who_has = OrderedSet(workers)
            ts.nbytes = ev.nbytes.get(key, ts.nbytes)
            if ts.state in ("released", "missing") and key not in self.data:
                recs[ts] = "fetch"
        return recs, []

    def _handle_steal_request(self, ev: StealRequestEvent) -> tuple[Recs, Instructions]:
        """Reference stealing.py:44-60: give up the task iff it has not
        started running."""
        ts = self.tasks.get(ev.key)
        state = ts.state if ts is not None else None
        instr: Instructions = [
            StealResponseMsg(stimulus_id=ev.stimulus_id, key=ev.key, state=state)
        ]
        recs: Recs = {}
        if ts is not None and state in ("ready", "constrained", "waiting"):
            recs[ts] = "released"
        return recs, instr

    def _handle_update_data(self, ev: UpdateDataEvent) -> tuple[Recs, Instructions]:
        recs: Recs = {}
        instr: Instructions = []
        for key, value in ev.data.items():
            ts = self.tasks.get(key)
            if ts is None:
                ts = self.tasks[key] = WTaskState(key)
                ts.priority = (0,)
            self.data[key] = value
            if ts.state in ("flight", "executing", "long-running", "cancelled",
                            "resumed"):
                # route through the transition table so in_flight/executing
                # bookkeeping is exited properly
                recs[ts] = "memory"
            else:
                r, i = self._put_memory(
                    ts, ev.stimulus_id, send_add_keys=ev.report
                )
                recs.update(r)
                instr += i
        return recs, instr

    def _handle_pause(self, ev: PauseEvent) -> tuple[Recs, Instructions]:
        self.running = False
        return {}, []

    def _handle_unpause(self, ev: UnpauseEvent) -> tuple[Recs, Instructions]:
        self.running = True
        return {}, []

    def _handle_retry_busy_worker(self, ev: RetryBusyWorkerEvent) -> tuple[Recs, Instructions]:
        self.busy_workers.discard(ev.worker)
        return {}, []

    def _handle_find_missing(self, ev: FindMissingEvent) -> tuple[Recs, Instructions]:
        missing = [
            ts for ts in self.tasks.values() if ts.state == "missing"
        ]
        if not missing:
            return {}, []
        return {}, [
            RequestRefreshWhoHasMsg(
                stimulus_id=ev.stimulus_id, keys=tuple(ts.key for ts in missing)
            )
        ]

    def _handle_refresh_who_has(self, ev: RefreshWhoHasEvent) -> tuple[Recs, Instructions]:
        recs: Recs = {}
        for key, workers in ev.who_has.items():
            ts = self.tasks.get(key)
            if ts is None:
                continue
            # drop rows for peers that no longer hold the key — a
            # refresh that only ever added left one has_what row per
            # departed replica behind (census-found)
            for w in ts.who_has.difference(workers):
                self._drop_has_what(w, key)
            ts.who_has = OrderedSet(workers)
            for w in workers:
                self.has_what[w].add(key)
            if ts.state == "missing" and ts.who_has:
                recs[ts] = "fetch"
            elif ts.state == "fetch" and not ts.who_has:
                recs[ts] = "missing"
        return recs, []

    # ------------------------------------------------------ transition engine

    def _transitions(self, recs: Recs, stimulus_id: str) -> Instructions:
        instructions: Instructions = []
        remaining = dict(recs)
        while remaining:
            ts, finish = remaining.popitem()
            instructions += self._transition(ts, finish, stimulus_id, remaining)
        return instructions

    def _transition(
        self, ts: WTaskState, finish: Any, stimulus_id: str, remaining: dict
    ) -> Instructions:
        recs, instructions = self._do_transition(ts, finish, stimulus_id)
        remaining.update(recs)
        return instructions

    def _do_transition(
        self, ts: WTaskState, finish: Any, stimulus_id: str
    ) -> tuple[Recs, Instructions]:
        kwargs: dict = {}
        if isinstance(finish, tuple):
            finish, payload = finish
            kwargs["payload"] = payload
        start = ts.state
        if start == finish:
            return {}, []
        self.transition_counter += 1
        # opt-in per-arm wall attribution (sim.profile_run's table);
        # routed pairs nest their released-leg arms, so self-time is
        # exact — mirrors SchedulerState._transition
        arms = self.WALL_ARMS
        if arms:
            self.wall.push(self._arm_phase(start, str(finish)), stimulus_id)
        try:
            func = self._transitions_table.get((start, finish))
            if func is not None:
                recs, instructions = func(ts, stimulus_id=stimulus_id, **kwargs)
                self.log.append((ts.key, start, ts.state, stimulus_id))
                return recs, instructions
            if "released" not in (start, finish):
                # no direct edge: route start -> released -> finish, replaying
                # any intermediate recommendations for ts along the way but
                # never forgetting it (reference wsm.py:2602-2629)
                recs, instructions = self._do_transition(
                    ts, "released", stimulus_id
                )
                while (v := recs.pop(ts, None)) is not None:
                    v_state = v[0] if isinstance(v, tuple) else v
                    if v_state == "forgotten":
                        continue
                    r2, i2 = self._do_transition(ts, v, stimulus_id)
                    recs.update(r2)
                    instructions += i2
                r3, i3 = self._do_transition(
                    ts, (finish, kwargs["payload"]) if kwargs else finish,
                    stimulus_id,
                )
                recs.update(r3)
                instructions += i3
                return recs, instructions
            raise InvalidTransition(ts.key, start, str(finish), list(self.log))
        finally:
            if arms:
                self.wall.pop()

    def _arm_phase(self, start: str, finish: str) -> str:
        """Interned wall-budget phase name for one worker transition arm."""
        p = self._arm_phases.get((start, finish))
        if p is None:
            p = self._arm_phases[(start, finish)] = (
                f"wengine.scalar-arm:{start},{finish}"
            )
        return p

    def _handler_phase(self, event_name: str) -> str:
        """Interned phase name for one stimulus-handler body."""
        key = (event_name, "")
        p = self._arm_phases.get(key)
        if p is None:
            p = self._arm_phases[key] = f"wengine.handler:{event_name}"
        return p

    # ------------------------------------------------------------- handlers

    def _transition_released_waiting(self, ts, *, stimulus_id):
        ts.state = "waiting"
        recs: Recs = {}
        if not ts.waiting_for_data:
            recs[ts] = "constrained" if ts.resource_restrictions else "ready"
        return recs, []

    def _transition_released_fetch(self, ts, *, stimulus_id):
        if not ts.who_has:
            return {ts: "missing"}, []
        ts.state = "fetch"
        for w in ts.who_has:
            self.has_what[w].add(ts.key)
            self.data_needed[w].add(ts)
        return {}, []

    def _transition_released_memory(self, ts, *, stimulus_id, payload=None):
        # ``payload`` arrives when an in-flight execute completes for a
        # task that went released (not cancelled-parked) in the
        # meantime: _handle_execute_success already stored the value
        # and nbytes, so keeping the replica and announcing it via
        # add-keys is the right outcome — the scheduler either wants it
        # or answers remove-replicas.  Without the parameter this arm
        # raised TypeError and killed the whole stimulus batch
        # (PYTHONHASHSEED-dependent crash found by the partition chaos
        # scenario; pre-existing — reproduced on the parent commit at
        # seeds 5 and 11).
        return self._put_memory(ts, stimulus_id, send_add_keys=True)

    def _transition_released_forgotten(self, ts, *, stimulus_id):
        if ts.dependents:
            return {}, []
        recs: Recs = {}
        for dts in ts.dependencies:
            dts.dependents.discard(ts)
            dts.waiters.discard(ts)
            if not dts.dependents and dts.state == "released":
                # orphaned released dependency: no release path will
                # ever run for it again, so forget it NOW (reference
                # wsm.py does the same; the old no-op here retained
                # ~14% of WTaskStates per chunk — found by the state
                # census's quiesce gate, tests/test_census.py)
                recs[dts] = "forgotten"
        ts.dependencies.clear()
        self._purge_replicas(ts)
        self.tasks.pop(ts.key, None)
        ts.state = "forgotten"
        return recs, []

    def _transition_redirected_waiting(self, ts, *, stimulus_id):
        """A data-target (fetch/missing) or failed task re-assigned as a
        compute: leave the dependency wiring the compute-task handler
        just built intact and enter waiting directly — the released
        fallback would clear ``waiting_for_data`` and race the task to
        ready without its inputs."""
        self._purge_data_needed(ts)
        ts.exception = None
        ts.traceback = None
        ts.exception_text = ""
        ts.traceback_text = ""
        return self._transition_released_waiting(ts, stimulus_id=stimulus_id)

    def _transition_waiting_ready(self, ts, *, stimulus_id):
        if self.validate:
            assert not ts.waiting_for_data, ts
            assert all(d.key in self.data for d in ts.dependencies), (
                ts,
                [(d.key, d.state, d.key in self.data)
                 for d in ts.dependencies],
                list(self.stimulus_log)[-8:],
            )
        ts.state = "ready"
        self.ready.add(ts)
        return {}, []

    def _transition_waiting_constrained(self, ts, *, stimulus_id):
        ts.state = "constrained"
        self.constrained.append(ts)
        return {}, []

    def _transition_ready_executing(self, ts, *, stimulus_id):
        self.ready.discard(ts)
        return self._start_executing(ts, stimulus_id)

    def _transition_constrained_executing(self, ts, *, stimulus_id):
        try:
            self.constrained.remove(ts)
        except ValueError:
            pass
        for r, q in ts.resource_restrictions.items():
            self.available_resources[r] -= q
        return self._start_executing(ts, stimulus_id)

    def _start_executing(self, ts, stimulus_id):
        ts.state = "executing"
        self.executing.add(ts)
        return {}, [Execute(stimulus_id=stimulus_id, key=ts.key)]

    def _transition_executing_memory(self, ts, *, stimulus_id, payload=None):
        self._exit_executing(ts)
        recs, instr = self._put_memory(ts, stimulus_id, send_add_keys=False)
        ev = payload
        startstops = ()
        if isinstance(ev, ExecuteSuccessEvent):
            startstops = (
                {"action": "compute", "start": ev.start, "stop": ev.stop},
            )
            ts.nbytes = ev.nbytes
        instr.append(
            TaskFinishedMsg(
                stimulus_id=stimulus_id,
                key=ts.key,
                nbytes=ts.nbytes,
                typename=getattr(ev, "type", None),
                startstops=startstops,
            )
        )
        return recs, instr

    def _transition_executing_error(self, ts, *, stimulus_id, payload=None):
        self._exit_executing(ts)
        ev = payload
        if ev is not None:
            ts.exception = getattr(ev, "exception", None)
            ts.traceback = getattr(ev, "traceback", None)
            ts.exception_text = getattr(ev, "exception_text", "")
            ts.traceback_text = getattr(ev, "traceback_text", "")
        ts.state = "error"
        return {}, [
            TaskErredMsg(
                stimulus_id=stimulus_id,
                key=ts.key,
                exception=ts.exception,
                traceback=ts.traceback,
                exception_text=ts.exception_text,
                traceback_text=ts.traceback_text,
            )
        ]

    def _transition_executing_released(self, ts, *, stimulus_id):
        """Cancellation while running: we cannot interrupt the thread, so the
        task enters `cancelled` until the executor reports back
        (reference wsm.py cancelled/resumed semantics)."""
        if ts.done:
            return self._transition_generic_released(ts, stimulus_id=stimulus_id)
        ts.previous = ts.state
        ts.state = "cancelled"
        ts.next = None
        return {}, []

    def _transition_executing_rescheduled(self, ts, *, stimulus_id):
        self._exit_executing(ts)
        ts.state = "rescheduled"
        recs = {ts: "released"}
        return recs, [RescheduleMsg(stimulus_id=stimulus_id, key=ts.key)]

    def _transition_executing_long_running(self, ts, *, stimulus_id, payload=None):
        self.executing.discard(ts)
        self.long_running.add(ts)
        ts.state = "long-running"
        dur = getattr(payload, "compute_duration", 0.0) if payload else 0.0
        return {}, [
            LongRunningMsg(
                stimulus_id=stimulus_id, key=ts.key, compute_duration=dur
            )
        ]

    def _transition_fetch_flight(self, ts, *, stimulus_id):
        ts.state = "flight"
        self.in_flight_tasks.add(ts)
        return {}, []

    def _transition_fetch_missing(self, ts, *, stimulus_id):
        self._purge_data_needed(ts)
        ts.state = "missing"
        return {}, []

    def _transition_missing_fetch(self, ts, *, stimulus_id):
        return self._transition_released_fetch(ts, stimulus_id=stimulus_id)

    def _transition_flight_memory(self, ts, *, stimulus_id):
        self.in_flight_tasks.discard(ts)
        ts.coming_from = None
        # add-keys tells the scheduler about the new replica — this is how
        # AMM replication registers (reference wsm.py flight->memory)
        return self._put_memory(ts, stimulus_id, send_add_keys=True)

    def _transition_flight_fetch(self, ts, *, stimulus_id):
        self.in_flight_tasks.discard(ts)
        ts.coming_from = None
        if not ts.who_has:
            return {ts: "missing"}, []
        ts.state = "fetch"
        for w in ts.who_has:
            self.data_needed[w].add(ts)
        return {}, []

    def _transition_flight_missing(self, ts, *, stimulus_id):
        self.in_flight_tasks.discard(ts)
        ts.coming_from = None
        ts.state = "missing"
        return {}, []

    def _transition_flight_error(self, ts, *, stimulus_id, payload=None):
        self.in_flight_tasks.discard(ts)
        ts.coming_from = None
        # state is still "flight" here, so _exit_executing inside the
        # shared error path cannot mis-release execution resources
        return self._transition_executing_error(
            ts, stimulus_id=stimulus_id, payload=payload
        )

    def _transition_flight_released(self, ts, *, stimulus_id):
        # data may still arrive; remember to drop it
        ts.previous = "flight"
        ts.state = "cancelled"
        return {}, []

    def _transition_memory_released(self, ts, *, stimulus_id):
        if ts.key in self.data:
            self.nbytes_in_memory -= ts.nbytes
            del self.data[ts.key]
        self.actors.pop(ts.key, None)
        return self._transition_generic_released(ts, stimulus_id=stimulus_id)

    def _transition_cancelled_released(self, ts, *, stimulus_id):
        if not ts.done and ts.previous in ("executing", "long-running"):
            return {}, []  # still running; stay cancelled until done
        ts.previous = None
        return self._transition_generic_released(ts, stimulus_id=stimulus_id)

    def _transition_cancelled_waiting(self, ts, *, stimulus_id):
        """The scheduler wants a cancelled task computed again (reference
        wsm.py:2157): revert an interrupted execution in place, or mark a
        cancelled fetch as resumed-towards-compute."""
        if ts.previous == "executing":
            ts.state = "executing"  # forget the cancellation entirely
            ts.previous = None
            ts.next = None
            return {}, []
        if ts.previous == "long-running":
            ts.state = "long-running"
            ts.previous = None
            ts.next = None
            return {}, [
                LongRunningMsg(
                    stimulus_id=stimulus_id, key=ts.key, compute_duration=0.0
                )
            ]
        # previous == "flight": the fetch still runs; compute once it ends
        ts.state = "resumed"
        ts.next = "waiting"
        return {}, []

    def _transition_cancelled_fetch(self, ts, *, stimulus_id):
        """(reference wsm.py:2130)"""
        if ts.previous == "flight":
            if ts.done:
                return {ts: "released"}, []
            ts.state = "flight"  # forget the cancellation
            ts.previous = None
            return {}, []
        # previous executing/long-running: keep running; fetch afterwards
        ts.state = "resumed"
        ts.next = "fetch"
        return {}, []

    def _transition_resumed_fetch(self, ts, *, stimulus_id):
        """(reference wsm.py:2076)"""
        if ts.previous == "flight":
            if ts.done:
                # the old fetch ended without producing the value: honor
                # the resume-to-compute request
                ts.state = "released"
                ts.done = False
                ts.previous = None
                ts.next = None
                return {ts: "waiting"}, []
            ts.state = "flight"  # back where we started
            ts.previous = None
            ts.next = None
            return {}, []
        return {}, []  # executing/long-running: completion event decides

    def _transition_resumed_missing(self, ts, *, stimulus_id):
        return {ts: "fetch"}, []

    def _transition_resumed_released(self, ts, *, stimulus_id):
        """(reference wsm.py:2120)"""
        if ts.done:
            ts.previous = None
            ts.next = None
            return self._transition_generic_released(ts, stimulus_id=stimulus_id)
        ts.state = "cancelled"
        ts.next = None
        return {}, []

    def _transition_cancelled_memory(self, ts, *, stimulus_id, payload=None):
        # task was cancelled but completed anyway and scheduler re-wants it
        return self._transition_executing_memory(
            ts, stimulus_id=stimulus_id, payload=payload
        )

    def _transition_cancelled_error(self, ts, *, stimulus_id, payload=None):
        return self._transition_executing_error(
            ts, stimulus_id=stimulus_id, payload=payload
        )

    def _transition_generic_released(self, ts, *, stimulus_id):
        """Pull the task out of every queue and release (or forget)."""
        self._exit_executing(ts)
        self.ready.discard(ts)
        try:
            self.constrained.remove(ts)
        except ValueError:
            pass
        self.in_flight_tasks.discard(ts)
        self._purge_data_needed(ts)
        if ts.key in self.data:
            self.nbytes_in_memory -= ts.nbytes
            del self.data[ts.key]
        self.actors.pop(ts.key, None)

        recs: Recs = {}
        for dts in ts.waiting_for_data:
            dts.waiters.discard(ts)
            if not dts.waiters and dts.state in (
                "fetch", "flight", "missing",
            ):
                recs[dts] = "released"
        ts.waiting_for_data.clear()
        for dts in ts.dependencies:
            dts.waiters.discard(ts)
            if not dts.waiters and not dts.dependents - {ts} and dts.state == "released":
                recs[dts] = "forgotten"
        self._purge_replicas(ts)
        ts.state = "released"
        if not ts.dependents:
            recs[ts] = "forgotten"
        return recs, []

    def _drop_has_what(self, worker: str, key: Key) -> None:
        """Remove one ``has_what`` row without the defaultdict creating
        an empty per-peer shell for an unknown worker (and deleting the
        shell when the last row goes — with peer churn the empty sets
        themselves leak)."""
        s = self.has_what.get(worker)
        if s is not None:
            s.discard(key)
            if not s:
                del self.has_what[worker]

    def _purge_replicas(self, ts) -> None:
        """Drop the task's peer-replica bookkeeping: ``who_has`` and the
        per-peer ``has_what`` rows (empty rows deleted — with peer churn
        the empty-set shells themselves are a leak).  Reference wsm.py
        does this in ``_purge_state``; the census quiesce gate found
        released tasks pinning both sides here."""
        if ts.who_has:
            for w in ts.who_has:
                self._drop_has_what(w, ts.key)
            ts.who_has.clear()

    # ---------------------------------------------------------- helper bits

    def _put_memory(self, ts, stimulus_id, *, send_add_keys: bool):
        if ts.key not in self.data:
            # value was produced but already dropped: nothing to do
            ts.state = "released"
            return {}, []
        self.nbytes_in_memory += ts.nbytes
        ts.state = "memory"
        self._purge_data_needed(ts)
        recs: Recs = {}
        for dts in list(ts.waiters):
            dts.waiting_for_data.discard(ts)
            if not dts.waiting_for_data and dts.state == "waiting":
                recs[dts] = "constrained" if dts.resource_restrictions else "ready"
        ts.waiters.clear()
        instr: Instructions = []
        if send_add_keys:
            instr.append(AddKeysMsg(stimulus_id=stimulus_id, keys=(ts.key,)))
        return recs, instr

    def _exit_executing(self, ts) -> None:
        self.executing.discard(ts)
        self.long_running.discard(ts)
        if ts.resource_restrictions and ts.state in ("executing", "long-running", "cancelled"):
            for r, q in ts.resource_restrictions.items():
                self.available_resources[r] += q

    def _purge_data_needed(self, ts) -> None:
        for w in ts.who_has:
            dn = self.data_needed.get(w)
            if dn is not None:
                dn.discard(ts)
                if not dn:
                    del self.data_needed[w]

    def _gather_finished(self, worker: str) -> None:
        self.transfer_incoming_count = max(0, self.transfer_incoming_count - 1)

    # ------------------------------------------------- scheduling decisions

    def _ensure_computing(self, stimulus_id: str) -> Instructions:
        """Fill execution slots from the ready/constrained queues
        (reference wsm.py:1726)."""
        if not self.running:
            return []
        instructions: Instructions = []
        while self.constrained and self._executing_count() < self.nthreads:
            ts = self.constrained[0]
            if ts.state != "constrained":
                self.constrained.popleft()
                continue
            if not all(
                self.available_resources.get(r, 0) >= q
                for r, q in ts.resource_restrictions.items()
            ):
                break
            self.constrained.popleft()
            instructions += self._transitions({ts: "executing"}, stimulus_id)
        while self.ready and self._executing_count() < self.nthreads:
            ts = self.ready.pop()
            if ts.state != "ready":
                continue
            instructions += self._transitions({ts: "executing"}, stimulus_id)
        if self.execute_pipeline and self.ready:
            # pipeline extension: tiny tasks queue behind the busy
            # threads so the server can batch their thread handoffs
            # (split across the pool on multi-thread workers); stop at
            # the first non-tiny head (priority order is preserved —
            # skipping over it would reorder execution)
            limit = self.nthreads + self.execute_pipeline
            while self.ready and self._executing_count() < limit:
                ts = self.ready.peek()
                if ts.state != "ready":
                    self.ready.pop()
                    continue
                if (
                    ts.actor
                    or not (0.0 <= ts.duration < self.execute_pipeline_threshold)
                ):
                    break
                self.ready.pop()
                instructions += self._transitions({ts: "executing"}, stimulus_id)
        return instructions

    def _executing_count(self) -> int:
        return len(self.executing)

    def _ensure_communicating(self, stimulus_id: str) -> Instructions:
        """Issue GatherDep instructions for fetchable tasks
        (reference wsm.py:1531)."""
        if not self.running:
            return []
        instructions: Instructions = []
        while (
            self.data_needed
            and self.transfer_incoming_count < self.transfer_incoming_count_limit
        ):
            worker = self._select_worker_for_gather()
            if worker is None:
                break
            to_gather, total_nbytes = self._select_keys_for_gather(worker)
            if not to_gather:
                break
            self.in_flight_workers[worker] = OrderedSet(to_gather)
            self.transfer_incoming_count += 1
            recs: Recs = {}
            for key in to_gather:
                ts = self.tasks[key]
                ts.coming_from = worker
                recs[ts] = "flight"
            instructions += self._transitions(recs, stimulus_id)
            instructions.append(
                GatherDep(
                    stimulus_id=stimulus_id,
                    worker=worker,
                    to_gather=tuple(to_gather),
                    total_nbytes=total_nbytes,
                )
            )
        return instructions

    def _select_worker_for_gather(self) -> str | None:
        """Pick the peer whose queue holds the highest-priority fetchable
        task, skipping busy and already-in-flight peers (reference
        wsm.py:1600)."""
        best = None
        best_pri = None
        for worker, heap in list(self.data_needed.items()):
            if worker in self.busy_workers or worker in self.in_flight_workers:
                continue
            while heap and heap.peek().state != "fetch":
                heap.discard(heap.peek())
            if not heap:
                del self.data_needed[worker]
                continue
            pri = heap.peek().priority
            if best_pri is None or pri < best_pri:
                best_pri = pri
                best = worker
        return best

    def _select_keys_for_gather(self, worker: str) -> tuple[list[Key], int]:
        """Batch keys from one peer up to the message byte limit
        (reference wsm.py:1664)."""
        heap = self.data_needed.get(worker)
        keys: list[Key] = []
        total = 0
        while heap:
            ts = heap.peek()
            if ts.state != "fetch":
                heap.discard(ts)
                continue
            if keys and total + ts.nbytes > self.transfer_message_bytes_limit:
                break
            heap.discard(ts)
            keys.append(ts.key)
            total += ts.nbytes
        if heap is not None and not heap:
            self.data_needed.pop(worker, None)
        return keys, total

    # ------------------------------------------------------------ validation

    def validate_state(self) -> None:
        try:
            for key, ts in self.tasks.items():
                assert ts.key == key
                if ts.state == "memory":
                    assert key in self.data or ts.actor, ts
                if ts.state == "executing":
                    assert ts in self.executing, ts
                if ts.state == "ready":
                    assert ts in self.ready, ts
                if ts.state == "flight":
                    assert ts in self.in_flight_tasks, ts
                for dts in ts.waiting_for_data:
                    assert ts in dts.waiters, (ts, dts)
                    assert dts.state != "memory", (ts, dts)
            for ts in self.executing:
                # resumed: cancelled mid-execute, then wanted again — the
                # in-flight execute keeps running and its result is reused
                assert ts.state in ("executing", "cancelled", "resumed"), ts
            for worker, keys in self.in_flight_workers.items():
                for key in keys:
                    ts = self.tasks.get(key)
                    assert ts is None or ts.state in ("flight", "cancelled", "resumed"), ts
        except AssertionError as e:
            raise InvalidTaskState(str(e)) from e

    def story(self, *keys: Key) -> list[tuple]:
        return [entry for entry in self.log if entry[0] in keys]


@functools.lru_cache(maxsize=None)
def _snake(name: str) -> str:
    # cached: runs once per event CLASS, not once per stimulus (this sat
    # near the top of the trivial-task profile before)
    out = []
    for i, c in enumerate(name):
        if c.isupper() and i:
            out.append("_")
        out.append(c.lower())
    s = "".join(out)
    return s[: -len("_event")] if s.endswith("_event") else s
