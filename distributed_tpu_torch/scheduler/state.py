"""Scheduler state machine — the pure control-plane core.

This is the sans-IO heart of the scheduler, the equivalent of the reference's
``SchedulerState`` (scheduler.py:1554): every task in the cluster moves
through the states

    released -> waiting -> [processing | queued | no-worker] -> memory
                                   \\-> erred
    (any) -> released -> forgotten

via a transition engine: ``_transition(key, finish)`` dispatches on the
``(start, finish)`` pair (reference _TRANSITIONS_TABLE, scheduler.py:2889);
each handler mutates state and returns ``(recommendations, client_msgs,
worker_msgs)``; ``_transitions`` (scheduler.py:2045) drains recommendations
to a fixed point.  Every transition is appended to ``transition_log`` with a
``stimulus_id`` for causal tracing (``story``).

Worker placement (``decide_worker_*``, reference scheduler.py:2135-2336 and
module-level decide_worker :8550) is routed through ``self.placement`` — by
default the pure-python objective below, optionally the JAX co-processor in
``distributed_tpu_torch.ops.placement`` which batches these decisions into
cost-matrix kernels on device (the framework's north star).

This class performs **no IO**: it returns message dicts destined for workers
and clients; the networked ``Scheduler`` server drains them onto batched
comm streams.  That makes the whole control plane deterministic and unit
testable (reference test strategy tier 1, SURVEY.md §4).

The port's copy of ``distributed_tpu/scheduler/state.py``, line for line
but for these seams:

- ``SchedulerState(device=...)``: the fleet mirror is the port's
  :class:`~distributed_tpu_torch.scheduler.mirror.TorchMirror` on that
  device (``None`` means CUDA and raises without a card; ``"cpu"`` keeps
  the device view in CPU tensors), where the reference builds its
  ``SchedulerMirror``.  ``mirror=False`` stays a host-only state, and
  the periodic device paths (``scheduler/stealing.py``,
  ``scheduler/amm.py``) run on ``state.device``;
- ``placement`` takes the port's ``TorchPlacement``; its hooks are the
  reference's (``wants``/``resolve``, ``decide_worker``, ``plan_stim``,
  ``on_add_worker``/``on_remove_worker``, ``plan_graph``);
- ``attach_native`` attaches the port's native engine
  (``scheduler/native_engine.py`` over its own build of
  ``native/engine.cpp``); with ``build=True`` it raises when the library
  cannot be built instead of leaving the Python oracle in place.
"""

from __future__ import annotations

import logging
from collections import defaultdict, deque
from collections.abc import Iterable
from typing import Any, Callable

from distributed_tpu_torch import config
from distributed_tpu_torch.exceptions import (
    InvalidTaskState,
    InvalidTransition,
    KilledWorker,
    NoValidWorkerError,
    TransitionCounterMaxExceeded,
)
from distributed_tpu_torch.diagnostics.census import build_scheduler_census
from distributed_tpu_torch.diagnostics.selfprofile import WallBudget
from distributed_tpu_torch.graph.spec import TaskSpec
from distributed_tpu_torch.ledger import DecisionLedger
from distributed_tpu_torch.protocol.serialize import compact_frames, wrap_opaque
from distributed_tpu_torch.telemetry import ClusterTelemetry
from distributed_tpu_torch.tracing import (
    SECONDS_BUCKETS,
    SIZE_BUCKETS,
    FlightRecorder,
    Histogram,
)
from distributed_tpu_torch.utils import HeapSet, OrderedSet, key_split, time

logger = logging.getLogger("distributed_tpu_torch.scheduler")

Key = str

ALL_TASK_STATES = (
    "released",
    "waiting",
    "no-worker",
    "queued",
    "processing",
    "memory",
    "erred",
    "forgotten",
)

# worker lifecycle statuses (subset of reference Status enum, core.py:77)
WORKER_STATUS_RUNNING = "running"
WORKER_STATUS_PAUSED = "paused"
WORKER_STATUS_CLOSING = "closing"
WORKER_STATUS_CLOSING_GRACEFULLY = "closing_gracefully"
WORKER_STATUS_INIT = "init"

RUNNING_STATUSES = frozenset({WORKER_STATUS_RUNNING})


class TaskPrefix:
    """Statistics per function name, used for duration estimation
    (reference scheduler.py:923)."""

    __slots__ = (
        "name",
        "duration_average",
        "max_exec_time",
        "nbytes_total",
        "state_counts",
        "groups",
        "n_durations",
    )

    def __init__(self, name: str):
        self.name = name
        self.duration_average: float = -1.0
        self.max_exec_time: float = -1.0
        self.nbytes_total = 0
        self.n_durations = 0
        self.state_counts: defaultdict[str, int] = defaultdict(int)
        self.groups: set[TaskGroup] = set()

    def add_exec_time(self, duration: float) -> None:
        self.max_exec_time = max(duration, self.max_exec_time)
        if duration > 2 * self.duration_average:
            self.duration_average = -1.0  # invalidate on surprise (ref :947)

    def add_duration(self, duration: float) -> None:
        self.n_durations += 1
        if self.duration_average < 0:
            self.duration_average = duration
        else:
            self.duration_average = 0.5 * duration + 0.5 * self.duration_average

    def __repr__(self) -> str:
        return f"<TaskPrefix {self.name!r}>"


class Computation:
    """One batch of submitted graphs, for diagnostics
    (reference scheduler.py:864): groups the TaskGroups born in one
    ``update_graph`` so dashboards and dumps can slice cluster activity
    by submission instead of by prefix."""

    __slots__ = ("start", "groups", "id")

    def __init__(self, now: float | None = None):
        from distributed_tpu_torch.utils.misc import seq_name

        self.start = now if now is not None else time()
        self.groups: set[TaskGroup] = set()
        self.id = seq_name("computation")

    @property
    def stop(self) -> float:
        return max((tg.stop for tg in self.groups), default=0.0)

    @property
    def states(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for tg in self.groups:
            for st, n in tg.states.items():
                out[st] = out.get(st, 0) + n
        return out

    def __repr__(self) -> str:
        return (
            f"<Computation {self.id}: {len(self.groups)} groups, "
            f"{sum(self.states.values())} tasks>"
        )


class TaskGroup:
    """Statistics per key-group; unit of root-ish detection
    (reference scheduler.py:1033)."""

    __slots__ = (
        "name",
        "prefix",
        "states",
        "dependencies",
        "nbytes_total",
        "duration",
        "types",
        "start",
        "stop",
        "last_worker",
        "last_worker_tasks_left",
        "span_id",
        "n_tasks",
    )

    def __init__(self, name: str):
        self.name = name
        self.prefix: TaskPrefix | None = None
        self.states: dict[str, int] = dict.fromkeys(ALL_TASK_STATES, 0)
        self.dependencies: set[TaskGroup] = set()
        self.nbytes_total = 0
        self.duration = 0.0
        self.types: set[str] = set()
        self.start = 0.0
        self.stop = 0.0
        self.last_worker: WorkerState | None = None
        self.last_worker_tasks_left = 0
        self.span_id: str | None = None
        self.n_tasks = 0

    def add(self, ts: TaskState) -> None:
        self.states[ts.state] += 1
        self.n_tasks += 1
        ts.group = self

    def __len__(self) -> int:
        return self.n_tasks

    def __repr__(self) -> str:
        return f"<TaskGroup {self.name!r}: {self.n_tasks} tasks>"

    @property
    def done(self) -> bool:
        return sum(self.states.get(s, 0) for s in ("memory", "erred", "forgotten")) == self.n_tasks


# --------------------------------------------------------------------------
# Deferred materialization (docs/native_engine.md "authoritative SoA").
#
# While the native engine holds un-replayed transition records, the C++
# SoA — not the python objects — is the source of truth for the
# SoA-backed TaskState/WorkerState fields below.  Engines with pending
# records park themselves in this module-level registry; ANY read or
# write of a backed field drains it first (ordered replay through the
# same appliers the eager path uses, so materialized python state is
# bit-identical to the oracle's).  The registry is almost always empty
# — the fast path is one global truthiness check.
_NATIVE_PENDING: list = []


def _drain_native_pending() -> None:
    for eng in list(_NATIVE_PENDING):
        eng.sync()


class TaskState:
    """Per-task record on the scheduler (reference scheduler.py:1173).

    The fields exposed as properties below are SoA-backed: while the
    native engine defers materialization, their python slots may lag
    the authoritative C++ rows, and every access hydrates first (see
    ``_NATIVE_PENDING``).  Mutate them only through the property (or
    the registered hydration/write-back helpers — graft-lint's
    mirror-parity rule audits direct ``_``-slot writes)."""

    __slots__ = (
        "key",
        "run_spec",
        "priority",
        "_state",
        "dependencies",
        "dependents",
        "_waiting_on",
        "_waiters",
        "who_wants",
        "_who_has",
        "_processing_on",
        "_nbytes",
        "_type",
        "exception",
        "traceback",
        "exception_text",
        "traceback_text",
        "exception_blame",
        "erred_on",
        "suspicious",
        "retries",
        "host_restrictions",
        "worker_restrictions",
        "resource_restrictions",
        "loose_restrictions",
        "actor",
        "prefix",
        "group",
        "_metadata",
        "annotations",
        "run_id",
        "queueable",
        "_homed",
        "_ledger_row",
        "nrow",
        "_rootish",
        "_hash",
    )

    def __init__(self, key: Key, run_spec: Any, state: str = "released"):
        self.key = key
        self._hash = hash(key)
        self.run_spec = run_spec
        self.priority: tuple | None = None
        # SoA-backed slots are written directly here: a task under
        # construction is not yet registered with any engine
        self._state = state
        # relation fields are insertion-ordered (utils.collections.
        # OrderedSet), NOT hash-ordered sets: the transition engine's
        # recommendation order derives from iterating them, so this is
        # what makes engine outcomes deterministic across processes —
        # and what the native engine's SoA mirror (native_engine.py)
        # reproduces with plain C++ vectors
        self.dependencies: OrderedSet[TaskState] = OrderedSet()
        self.dependents: OrderedSet[TaskState] = OrderedSet()
        self._waiting_on: OrderedSet[TaskState] = OrderedSet()
        self._waiters: OrderedSet[TaskState] = OrderedSet()
        # insertion-ordered like the relation fields: report/erred
        # client messages are emitted by iterating this
        self.who_wants: OrderedSet[ClientState] = OrderedSet()
        self._who_has: OrderedSet[WorkerState] = OrderedSet()
        self._processing_on: WorkerState | None = None
        self._nbytes = -1
        self._type: str | None = None
        self.exception: Any = None
        self.traceback: Any = None
        self.exception_text = ""
        self.traceback_text = ""
        self.exception_blame: TaskState | None = None
        # insertion-ordered: free-keys messages are built by iterating
        # this (one worker_msgs row per erred-on address)
        self.erred_on: OrderedSet[str] = OrderedSet()
        self.suspicious = 0
        self.retries = 0
        self.host_restrictions: set[str] | None = None
        self.worker_restrictions: set[str] | None = None
        self.resource_restrictions: dict[str, float] | None = None
        self.loose_restrictions = False
        self.actor = False
        self.prefix: TaskPrefix | None = None
        self.group: TaskGroup | None = None
        self._metadata: dict | None = None
        self.annotations: dict | None = None
        self.run_id: int | None = None
        self.queueable = True
        # placed on its plan-assigned home worker: exempt from stealing
        # (the balancer scattering a co-assigned tile undoes the plan's
        # whole point); cleared on processing exit and on home pause.
        # Truthy values carry provenance for the decision ledger:
        # "plan" = jax_placement plan home, "pin" = shuffle pin (same
        # steal exemption, different ledger attribution)
        self._homed: bool | str = False
        # open decision-ledger row handle (ledger.py): -1 = none.  The
        # handle lives on the task instead of a key-indexed dict so the
        # file/join hot path pays no string hash; stale handles are
        # validity-checked by the ledger.
        self._ledger_row = -1
        # stable row in the native engine's SoA (scheduler/
        # native_engine.py): -1 = not registered
        self.nrow = -1
        self._rootish: bool | None = None

    def __repr__(self) -> str:
        return f"<TaskState {self.key!r} {self.state}>"

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other: object) -> bool:
        return self is other

    @property
    def group_key(self) -> str:
        return self.group.name if self.group else key_split(self.key)

    def get_nbytes(self) -> int:
        return self.nbytes if self.nbytes >= 0 else DEFAULT_DATA_SIZE

    def add_dependency(self, dep: TaskState) -> None:
        self.dependencies.add(dep)
        if self.group is not None and dep.group is not None and dep.group is not self.group:
            self.group.dependencies.add(dep.group)
        dep.dependents.add(self)

    @property
    def has_restrictions(self) -> bool:
        return bool(
            self.host_restrictions or self.worker_restrictions or self.resource_restrictions
        )

    # SoA-backed fields: explicit property pairs (not a factory loop) so
    # the hot oracle path pays one global truthiness check + slot access

    @property
    def state(self) -> str:
        if _NATIVE_PENDING:
            _drain_native_pending()
        return self._state

    @state.setter
    def state(self, value: str) -> None:
        if _NATIVE_PENDING:
            _drain_native_pending()
        self._state = value

    @property
    def waiting_on(self) -> OrderedSet[TaskState]:
        if _NATIVE_PENDING:
            _drain_native_pending()
        return self._waiting_on

    @waiting_on.setter
    def waiting_on(self, value: OrderedSet[TaskState]) -> None:
        if _NATIVE_PENDING:
            _drain_native_pending()
        self._waiting_on = value

    @property
    def waiters(self) -> OrderedSet[TaskState]:
        if _NATIVE_PENDING:
            _drain_native_pending()
        return self._waiters

    @waiters.setter
    def waiters(self, value: OrderedSet[TaskState]) -> None:
        if _NATIVE_PENDING:
            _drain_native_pending()
        self._waiters = value

    @property
    def who_has(self) -> OrderedSet[WorkerState]:
        if _NATIVE_PENDING:
            _drain_native_pending()
        return self._who_has

    @who_has.setter
    def who_has(self, value: OrderedSet[WorkerState]) -> None:
        if _NATIVE_PENDING:
            _drain_native_pending()
        self._who_has = value

    @property
    def processing_on(self) -> WorkerState | None:
        if _NATIVE_PENDING:
            _drain_native_pending()
        return self._processing_on

    @processing_on.setter
    def processing_on(self, value: WorkerState | None) -> None:
        if _NATIVE_PENDING:
            _drain_native_pending()
        self._processing_on = value

    @property
    def nbytes(self) -> int:
        if _NATIVE_PENDING:
            _drain_native_pending()
        return self._nbytes

    @nbytes.setter
    def nbytes(self, value: int) -> None:
        if _NATIVE_PENDING:
            _drain_native_pending()
        self._nbytes = value

    @property
    def type(self) -> str | None:
        if _NATIVE_PENDING:
            _drain_native_pending()
        return self._type

    @type.setter
    def type(self, value: str | None) -> None:
        if _NATIVE_PENDING:
            _drain_native_pending()
        self._type = value

    @property
    def metadata(self) -> dict | None:
        if _NATIVE_PENDING:
            _drain_native_pending()
        return self._metadata

    @metadata.setter
    def metadata(self, value: dict | None) -> None:
        if _NATIVE_PENDING:
            _drain_native_pending()
        self._metadata = value

    @property
    def homed(self) -> bool | str:
        if _NATIVE_PENDING:
            _drain_native_pending()
        return self._homed

    @homed.setter
    def homed(self, value: bool | str) -> None:
        if _NATIVE_PENDING:
            _drain_native_pending()
        self._homed = value

    @property
    def ledger_row(self) -> int:
        if _NATIVE_PENDING:
            _drain_native_pending()
        return self._ledger_row

    @ledger_row.setter
    def ledger_row(self, value: int) -> None:
        if _NATIVE_PENDING:
            _drain_native_pending()
        self._ledger_row = value


DEFAULT_DATA_SIZE = 1024  # bytes assumed for unknown results


class ClientState:
    """Per-client record (reference scheduler.py:196)."""

    __slots__ = ("client_key", "wants_what", "last_seen", "versions")

    def __init__(self, client: str, now: float | None = None):
        self.client_key = client
        # insertion-ordered: client-releases and restart paths iterate
        # this to build key lists
        self.wants_what: OrderedSet[TaskState] = OrderedSet()
        self.last_seen = now if now is not None else time()
        self.versions: dict = {}

    def __repr__(self) -> str:
        return f"<ClientState {self.client_key!r}>"

    def __hash__(self) -> int:
        return hash(self.client_key)


class WorkerState:
    """Scheduler-side mirror of one worker (reference scheduler.py:406).

    ``nbytes``/``has_what``/``processing``/``occupancy``/``long_running``
    are SoA-backed like the TaskState fields above: property access
    drains pending native records first."""

    __slots__ = (
        "address",
        "name",
        "nthreads",
        "memory_limit",
        "status",
        "_nbytes",
        "_has_what",
        "_processing",
        "_long_running",
        "executing",
        "resources",
        "used_resources",
        "_occupancy",
        "_network_occ",
        "last_seen",
        "status_changed_at",
        "status_seq",
        "metrics",
        "memory_unmanaged_old",
        "bandwidth",
        "actors",
        "extra",
        "server_id",
        "idx",
        "nidx",
    )

    def __init__(
        self,
        address: str,
        nthreads: int = 1,
        memory_limit: int = 0,
        name: object = None,
        server_id: str | None = None,
    ):
        self.address = address
        self.name = name if name is not None else address
        self.nthreads = nthreads
        self.memory_limit = memory_limit
        self.status = WORKER_STATUS_RUNNING
        self._nbytes = 0
        self._has_what: dict[TaskState, None] = {}  # insertion-ordered set
        self._processing: dict[TaskState, float] = {}
        self._long_running: set[TaskState] = set()
        self.executing: dict[TaskState, float] = {}
        self.resources: dict[str, float] = {}
        # diagnostics-only: placement filters by SUPPLY (valid_workers);
        # actual execution concurrency is constrained worker-side
        self.used_resources: dict[str, float] = {}
        self._occupancy = 0.0
        self._network_occ = 0  # bytes pending transfer to this worker
        self.last_seen = time()
        self.status_changed_at = 0.0  # last stream-delivered status flip
        # worker-stamped monotonic sequence of the last applied status
        # flip: a heartbeat's status view is reconciled only when its
        # seq proves it is at least as new (see heartbeat_worker)
        self.status_seq = 0
        self.metrics: dict = {}
        self.memory_unmanaged_old = 0
        self.bandwidth = float(config.get("scheduler.bandwidth"))
        self.actors: set[TaskState] = set()
        self.extra: dict = {}
        self.server_id = server_id or address
        self.idx = -1  # stable slot in the device mirror (ops/)
        self.nidx = -1  # stable slot in the native engine SoA

    def __repr__(self) -> str:
        return (
            f"<WorkerState {self.address!r} status: {self.status} "
            f"processing: {len(self.processing)} has_what: {len(self.has_what)}>"
        )

    def __hash__(self) -> int:
        return hash(self.server_id)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, WorkerState) and other.server_id == self.server_id

    def clean(self) -> WorkerState:
        ws = WorkerState(self.address, self.nthreads, self.memory_limit, self.name)
        ws.status = self.status
        return ws

    @property
    def nbytes(self) -> int:
        if _NATIVE_PENDING:
            _drain_native_pending()
        return self._nbytes

    @nbytes.setter
    def nbytes(self, value: int) -> None:
        if _NATIVE_PENDING:
            _drain_native_pending()
        self._nbytes = value

    @property
    def has_what(self) -> dict[TaskState, None]:
        if _NATIVE_PENDING:
            _drain_native_pending()
        return self._has_what

    @has_what.setter
    def has_what(self, value: dict[TaskState, None]) -> None:
        if _NATIVE_PENDING:
            _drain_native_pending()
        self._has_what = value

    @property
    def processing(self) -> dict[TaskState, float]:
        if _NATIVE_PENDING:
            _drain_native_pending()
        return self._processing

    @processing.setter
    def processing(self, value: dict[TaskState, float]) -> None:
        if _NATIVE_PENDING:
            _drain_native_pending()
        self._processing = value

    @property
    def long_running(self) -> set[TaskState]:
        if _NATIVE_PENDING:
            _drain_native_pending()
        return self._long_running

    @long_running.setter
    def long_running(self, value: set[TaskState]) -> None:
        if _NATIVE_PENDING:
            _drain_native_pending()
        self._long_running = value

    @property
    def occupancy(self) -> float:
        if _NATIVE_PENDING:
            _drain_native_pending()
        return self._occupancy

    @occupancy.setter
    def occupancy(self, value: float) -> None:
        if _NATIVE_PENDING:
            _drain_native_pending()
        self._occupancy = value


class SchedulerState:
    """The whole mutable scheduler core (reference scheduler.py:1554)."""

    def __init__(
        self,
        *,
        validate: bool | None = None,
        transition_counter_max: int | None = None,
        placement: Any | None = None,
        mirror: bool | None = None,
        clock: Callable[[], float] | None = None,
        device: Any = None,
    ):
        # injectable clock (ROADMAP item 1 simulator): every timestamp
        # this engine writes — transition-log rows, event stamps,
        # no-worker parking, nthreads history — reads ``self.clock``.
        # Default is the monotonic utils.misc.time; the sans-io cluster
        # simulator (distributed_tpu_torch/sim) passes its VirtualClock so a
        # whole cluster's control plane runs on virtual seconds.
        self.clock = clock if clock is not None else time
        # flight recorder + engine histograms (tracing.py;
        # docs/observability.md) — created FIRST: worker registration and
        # the mirror emit through them during the rest of this __init__
        self.trace = FlightRecorder()
        self.trace.clock = self.clock
        # wall-budget phase attribution (diagnostics/selfprofile.py;
        # docs/observability.md "Self-profiling"): exact monotonic
        # accumulators entered at the hot-path seams.  Always REAL
        # monotonic time, even under the simulator's virtual clock —
        # the budget measures python cost, not simulated time.
        self.wall = WallBudget()
        # per-transition-arm attribution (engine.scalar-arm:<s>,<f>):
        # opt-in — two monotonic reads per transition are not free on
        # the flood path, so sim.profile_run turns it on explicitly
        self.WALL_ARMS: bool = bool(
            config.get("scheduler.profile.arm-attribution", False)
        )
        self._arm_phases: dict[tuple[str, str], str] = {}
        # recommendations per engine pass / flood fold size
        self.hist_engine_batch = Histogram(SIZE_BUCKETS)
        # wall seconds per engine pass (one flood fold or one
        # recommendation round drained to its fixed point)
        self.hist_engine_pass = Histogram(SECONDS_BUCKETS)
        # messages folded per coalesced egress envelope (server-side
        # observe site: Scheduler.stream_payload_flush)
        self.hist_egress = Histogram(SIZE_BUCKETS)
        # per-shard telemetry of the SHARDED placement engine (mesh
        # plan path, scheduler/jax_placement.py): one entry per mesh
        # shard — last plan's kernel completion ms, cumulative H2D
        # bytes, plans counted.  Exposed as dtpu_engine_shard_* at
        # /metrics; empty until a sharded plan ran.
        self.engine_shards: list[dict] = []
        # measured-truth telemetry plane (telemetry.py): fleet link
        # EWMAs/t-digests folded from worker heartbeats, task-prefix
        # priors, and the shadow cost-model divergence monitor.
        # STRICTLY read-only: no decision path consults it (property-
        # tested in tests/test_telemetry.py); ROADMAP item 3 swaps the
        # kernel inputs in a future PR.
        self.telemetry = ClusterTelemetry()
        self.telemetry.clock = self.clock
        # decision–outcome ledger (ledger.py; docs/observability.md
        # "Decision ledger & critical-path"): every placement / steal /
        # AMM replica decision files a bounded preallocated row carrying
        # the prediction (constants AND the telemetry plane's measured shadow); the
        # realized outcome joins it at memory/erred/confirm and emits
        # per-decision regret.  Runs on the same injectable clock, so
        # the simulator's joins are exact and deterministic.
        self.ledger = DecisionLedger()
        self.ledger.clock = self.clock
        self.tasks: dict[Key, TaskState] = {}
        self.task_groups: dict[str, TaskGroup] = {}
        # one entry per update_graph batch (reference scheduler.py:864)
        self.computations: deque[Computation] = deque(
            maxlen=config.get("diagnostics.computations.max-history")
        )
        self.task_prefixes: dict[str, TaskPrefix] = {}
        self.workers: dict[str, WorkerState] = {}
        self.aliases: dict[object, str] = {}  # name -> address
        self.clients: dict[str, ClientState] = {}
        self.host_info: defaultdict[str, dict] = defaultdict(dict)
        self.resources: defaultdict[str, dict[str, float]] = defaultdict(dict)

        self.idle: dict[str, WorkerState] = {}
        # insertion-ordered like the task relation fields: the steal
        # balancer's victim scan iterates saturated, and restart
        # recovery (scheduler/durability.py) must rebuild the exact
        # iteration order — built-in set order is allocation-dependent
        self.idle_task_count: OrderedSet[WorkerState] = OrderedSet()
        self.saturated: OrderedSet[WorkerState] = OrderedSet()
        self.running: set[WorkerState] = set()

        self.queued: HeapSet[TaskState] = HeapSet(key=lambda ts: ts.priority)
        # placement-parked subset of ``queued``: tasks deferred for ONE
        # worker's next slot-open (plan co-assignment), indexed by home
        # address.  They are deliberately kept OUT of the globally
        # poppable heap — a queue head wall-to-wall with parked tasks
        # would otherwise be re-scanned on every completion.
        # queued == queued_unparked  ∪  {tasks in parked heaps}
        self.queued_unparked: HeapSet[TaskState] = HeapSet(
            key=lambda ts: ts.priority
        )
        self.parked: dict[str, HeapSet[TaskState]] = {}
        self._parked_keys: dict[Key, str] = {}
        self.unrunnable: dict[TaskState, float] = {}
        # insertion-ordered: ReduceReplicas iterates this to yield
        # drop suggestions (amm.py), so scan order is decision order
        self.replicated_tasks: OrderedSet[TaskState] = OrderedSet()

        self.validate = (
            validate if validate is not None else config.get("scheduler.validate")
        )
        self.transition_counter = 0
        self.transition_counter_max = transition_counter_max
        # SoA-backed like the TaskState fields: read through the
        # ``transition_log`` property, which drains pending native
        # records so deferred story rows materialize first
        self._transition_log: deque = deque(
            maxlen=config.get("scheduler.transition-log-length")
        )
        self._transitions_table: dict[tuple[str, str], Callable] = {
            ("released", "waiting"): self._transition_released_waiting,
            ("waiting", "released"): self._transition_waiting_released,
            ("waiting", "processing"): self._transition_waiting_processing,
            ("waiting", "queued"): self._transition_waiting_queued,
            ("waiting", "no-worker"): self._transition_waiting_no_worker,
            ("waiting", "memory"): self._transition_waiting_memory,
            ("queued", "released"): self._transition_queued_released,
            ("queued", "processing"): self._transition_queued_processing,
            ("processing", "released"): self._transition_processing_released,
            ("processing", "memory"): self._transition_processing_memory,
            ("processing", "erred"): self._transition_processing_erred,
            ("no-worker", "released"): self._transition_no_worker_released,
            ("no-worker", "erred"): self._transition_no_worker_erred,
            ("no-worker", "processing"): self._transition_no_worker_processing,
            ("released", "forgotten"): self._transition_released_forgotten,
            ("memory", "forgotten"): self._transition_memory_forgotten,
            ("erred", "released"): self._transition_erred_released,
            ("memory", "released"): self._transition_memory_released,
            ("released", "erred"): self._transition_released_erred,
            ("released", "memory"): self._transition_released_memory,
        }

        # hot-path config cached at init (reference scheduler.py:1756-1791)
        self.UNKNOWN_TASK_DURATION: float = config.parse_timedelta(
            config.get("scheduler.unknown-task-duration")
        )
        ws_cfg = config.get("scheduler.worker-saturation")
        self.WORKER_SATURATION: float = float("inf") if ws_cfg in ("inf", None) else float(ws_cfg)
        self.bandwidth: float = float(config.get("scheduler.bandwidth"))
        self.transfer_latency: float = config.parse_timedelta(
            config.get("scheduler.transfer-latency")
        )
        self.ALLOWED_FAILURES: int = config.get("scheduler.allowed-failures")
        self.DEFAULT_TASK_DURATIONS: dict[str, float] = {
            k: config.parse_timedelta(v)
            for k, v in config.get("scheduler.default-task-durations").items()
        }

        self.total_nthreads = 0
        # bounded: one row per fleet-capacity flip — as a plain list
        # this grew forever under autoscaling churn (census-found; the
        # reference keeps the same unbounded list)
        self.total_nthreads_history: deque[tuple[float, int]] = deque(
            [(self.clock(), 0)], maxlen=4096
        )
        self._total_occupancy = 0.0
        self.n_tasks = 0
        self.plugins: dict[str, Any] = {}
        self.placement = placement  # JAX co-processor hook (ops/placement.py)
        # where the mirror's device view and the periodic device paths run
        self.device = device
        # persistent fleet SoA shared by every co-processor kernel
        # (scheduler/mirror.py); None = consumers use the from-scratch
        # Python pack (the oracle) every cycle
        self.mirror: Any | None = None
        if mirror if mirror is not None else config.get("scheduler.jax.mirror", True):
            from distributed_tpu_torch.scheduler.mirror import TorchMirror

            self.mirror = TorchMirror(
                self,
                capacity_doubling=bool(
                    config.get("scheduler.jax.capacity-doubling")
                ),
                device=device,
            )
            self.device = self.mirror.device
        # native (C++) transition engine for the four dominant arms
        # (scheduler/native_engine.py; docs/native_engine.md).  None =
        # the pure-python oracle runs everything.  Attach never blocks
        # on a g++ compile here: servers prebuild asynchronously and
        # re-attach on the ready callback; sim/bench contexts call
        # attach_native(build=True) explicitly.
        self.native: Any | None = None
        if config.get("scheduler.native-engine.enabled") and not self.validate:
            self.attach_native()
        self.extensions: dict[str, Any] = {}
        # durability dirty-mark tracker (scheduler/durability.py): when
        # attached, out-of-engine mutations (replica truth, worker
        # lifecycle, client interest) mark rows here so incremental
        # snapshots re-serialize O(changed) task rows; per-transition
        # marks are direct calls from the _transition funnel and from
        # the native tape replay's transition arms (both engines feed
        # the same dirty sets).
        self.durability: Any | None = None
        self.events_subscriber_hook: Callable | None = None
        self.events: defaultdict[str, deque] = defaultdict(
            lambda: deque(maxlen=config.get("scheduler.events-log-length"))
        )
        self.event_counts: defaultdict[str, int] = defaultdict(int)
        self.task_metadata: dict = {}
        self.unknown_durations: dict[str, set[TaskState]] = {}
        # state census (diagnostics/census.py; docs/observability.md
        # "State census & retention"): typed inventory of every
        # long-lived container above — built LAST so every probe
        # closure sees the final containers.  Registration is the
        # contract: a new container attribute must be census-registered
        # or allowlisted with a reason (tests/test_census.py).
        self.census = build_scheduler_census(self)

    # ------------------------------------------------------------------ misc

    def attach_native(self, build: bool = False) -> bool:
        """Attach the native transition engine if the compiled library
        is available (``build=True`` compiles on demand — only call off
        the event loop).  Idempotent; returns True when attached."""
        if self.native is not None:
            return True
        from distributed_tpu_torch.scheduler.native_engine import NativeEngine

        self.native = NativeEngine.attach(self, build=build)
        return self.native is not None

    @property
    def memory_total(self) -> int:
        return sum(ws.memory_limit for ws in self.workers.values())

    def new_task_prefix(self, name: str) -> TaskPrefix:
        tp = self.task_prefixes.get(name)
        if tp is None:
            tp = self.task_prefixes[name] = TaskPrefix(name)
            if name in self.DEFAULT_TASK_DURATIONS:
                tp.duration_average = self.DEFAULT_TASK_DURATIONS[name]
        return tp

    def new_task(
        self,
        key: Key,
        run_spec: Any,
        state: str = "released",
        computation: Any = None,
    ) -> TaskState:
        """Create and register a new TaskState (reference scheduler.py:1817)."""
        ts = TaskState(key, run_spec, state)
        prefix_key = key_split(key)
        tp = self.new_task_prefix(prefix_key)
        ts.prefix = tp
        tp.state_counts[state] += 1
        group_key = prefix_key  # group == prefix family for string keys
        tg = self.task_groups.get(group_key)
        if tg is None:
            tg = self.task_groups[group_key] = TaskGroup(group_key)
            tg.prefix = tp
            tp.groups.add(tg)
        tg.add(ts)
        self.tasks[key] = ts
        self.n_tasks += 1
        if self.native is not None:
            self.native.on_new_task(ts)
        if self.durability is not None:
            self.durability.mark_task(ts)
        return ts

    def _clear_task_state(self) -> None:
        for coll in (
            self.tasks,
            self.task_groups,
            self.task_prefixes,
            self.unrunnable,
            self.replicated_tasks,
        ):
            coll.clear()
        self.queued.clear()
        self.queued_unparked.clear()
        self.parked.clear()
        self._parked_keys.clear()
        # per-worker mirrors reference the cleared TaskStates: reset them
        # too or memory/occupancy accounting is permanently wrong
        for ws in self.workers.values():
            ws.has_what.clear()
            ws.processing.clear()
            ws.long_running.clear()
            ws.executing.clear()
            ws.actors.clear()
            ws.nbytes = 0
            ws.occupancy = 0.0
            ws._network_occ = 0
            ws.used_resources = dict.fromkeys(ws.used_resources, 0)
            self.check_idle_saturated(ws)
        self._total_occupancy = 0.0
        # open decision rows reference the cleared tasks: close them so
        # they don't age out as false unjoineds after a restart
        self.ledger.resolve_all("released", now=self.clock())
        if self.native is not None:
            self.native.reset()

    # ------------------------------------------------- transition engine

    def _transition(
        self, key: Key, finish: str, stimulus_id: str, **kwargs: Any
    ) -> tuple[dict, dict, dict]:
        """Move task ``key`` to state ``finish`` (reference scheduler.py:1909).

        Returns (recommendations, client_msgs, worker_msgs).  Unknown
        (start, finish) pairs route through "released" like the reference
        (scheduler.py:1961-1984).
        """
        ts = self.tasks.get(key)
        if ts is None:
            return {}, {}, {}
        start = ts.state
        if start == finish:
            return {}, {}, {}
        if self.transition_counter_max:
            if self.transition_counter >= self.transition_counter_max:
                raise TransitionCounterMaxExceeded(key, start, finish, self.story(key))
        self.transition_counter += 1

        # opt-in per-arm wall attribution (sim.profile_run's table):
        # everything from dispatch through log/trace/plugins bills to
        # this (start, finish) arm; a routed pair's released leg nests
        # its own arm, so self-time stays exact
        arms = self.WALL_ARMS
        if arms:
            self.wall.push(self._arm_phase(start, finish), stimulus_id)
        try:
            func = self._transitions_table.get((start, finish))
            if func is not None:
                recommendations, client_msgs, worker_msgs = func(
                    key, stimulus_id=stimulus_id, **kwargs
                )
            elif "released" not in (start, finish):
                # untable'd pair: route through released (reference scheduler.py:1961)
                assert not kwargs, (kwargs, start, finish)
                a_recs, a_cmsgs, a_wmsgs = self._transition(key, "released", stimulus_id)
                v = a_recs.get(key, finish)
                func = self._transitions_table.get(("released", v))
                if func is None:
                    raise InvalidTransition(key, start, finish, self.story(key))
                b_recs, b_cmsgs, b_wmsgs = func(key, stimulus_id=stimulus_id)
                recommendations = {**a_recs, **b_recs}
                client_msgs = _merge_msgs(a_cmsgs, b_cmsgs)
                worker_msgs = _merge_msgs(a_wmsgs, b_wmsgs)
                start = "released"
            else:
                raise InvalidTransition(key, start, finish, self.story(key))

            actual_finish = ts.state
            self.transition_log.append(
                (key, start, actual_finish, dict(recommendations), stimulus_id, self.clock())
            )
            # task-level trace hop (sampled 1-in-N): name=finish, dest=start
            # — interned strings only, so the flood fast path allocates
            # nothing (the bench-smoke "trace" gate enforces both the alloc
            # contract and the <5% traced-on overhead)
            self.trace.emit_task(
                "transition", actual_finish, stimulus_id, key=key, dest=start
            )
            if self.validate:
                self.validate_task_state(ts)
            if self.plugins:
                for plugin in list(self.plugins.values()):
                    try:
                        plugin.transition(
                            key, start, actual_finish, stimulus_id=stimulus_id, **kwargs
                        )
                    except Exception:
                        logger.exception("Plugin %r failed in transition", plugin)
            return recommendations, client_msgs, worker_msgs
        finally:
            # native SoA delta-consistency: an oracle transition may
            # have touched ts and both relation neighborhoods
            if self.native is not None:
                self.native.mark_transition(ts)
            # durability dirty mark — direct call, not the plugin seam:
            # the dispatch machinery costs more than the mark and this
            # runs per transition on the flood path
            if self.durability is not None:
                self.durability.mark_transition(ts)
            if arms:
                self.wall.pop()

    def _arm_phase(self, start: str, finish: str) -> str:
        """Interned wall-budget phase name for one transition arm —
        built once per (start, finish) pair so the opt-in hot path never
        formats strings per transition."""
        p = self._arm_phases.get((start, finish))
        if p is None:
            p = self._arm_phases[(start, finish)] = (
                f"engine.scalar-arm:{start},{finish}"
            )
        return p

    def _transitions(
        self,
        recommendations: dict[Key, str],
        client_msgs: dict,
        worker_msgs: dict,
        stimulus_id: str,
    ) -> None:
        """Drain recommendations to a fixed point (reference scheduler.py:2045)."""
        keys: set[Key] = set()
        recommendations = dict(recommendations)
        while recommendations:
            key, finish = recommendations.popitem()
            keys.add(key)
            new_recs, new_cmsgs, new_wmsgs = self._transition(key, finish, stimulus_id)
            recommendations.update(new_recs)
            _merge_msgs_inplace(client_msgs, new_cmsgs)
            _merge_msgs_inplace(worker_msgs, new_wmsgs)
        if self.validate:
            for key in keys:
                ts = self.tasks.get(key)
                if ts is not None:
                    self.validate_task_state(ts)

    def _drain_round(
        self,
        recommendations: dict[Key, str],
        client_msgs: dict,
        worker_msgs: dict,
        stimulus_id: str,
    ) -> None:
        """One recommendation round: the native engine when attached
        and eligible (scheduler/native_engine.py — escapes per key back
        to the oracle), else the pure-python drain.  Both paths produce
        bit-identical state, stories and message multisets; the oracle
        stays selectable at runtime (scheduler.native-engine.enabled,
        DTPU_NATIVE_DISABLE)."""
        ne = self.native
        if ne is not None and ne.active():
            ne.drive_recs_round(
                recommendations, stimulus_id, client_msgs, worker_msgs
            )
        else:
            self._transitions(
                dict(recommendations), client_msgs, worker_msgs, stimulus_id
            )

    def transitions(self, recommendations: dict[Key, str], stimulus_id: str) -> tuple[dict, dict]:
        """Public entry: process recommendations, return (client_msgs, worker_msgs)."""
        tr = self.trace
        if tr.journal_enabled:
            tr.record(
                "transitions", {"recs": dict(recommendations)}, stimulus_id
            )
        return self._transitions_observed(recommendations, stimulus_id)

    def _transitions_observed(
        self, recommendations: dict[Key, str], stimulus_id: str
    ) -> tuple[dict, dict]:
        """One observed engine round WITHOUT a journal record: the drain
        plus the histogram/trace-ring observations.  Journaled stimuli
        that drive an engine round internally (reschedule,
        missing-data) MUST use this — their own journal op replays the
        round, so a nested ``transitions`` record would run it twice
        on replay (the same rule release-worker-data documents)."""
        client_msgs: dict = {}
        worker_msgs: dict = {}
        t0 = self.clock()
        self.wall.push("engine.drain", stimulus_id)
        try:
            self._drain_round(
                recommendations, client_msgs, worker_msgs, stimulus_id
            )
        finally:
            self.wall.pop()
        # histograms observe regardless of trace.enabled: dtpu_engine_*
        # are documented /metrics families, not trace output
        n = len(recommendations)
        self.hist_engine_batch.observe(n)
        self.hist_engine_pass.observe(self.clock() - t0)
        self.trace.emit("engine", "transitions", stimulus_id, n=n)
        return client_msgs, worker_msgs

    @property
    def transition_log(self) -> deque:
        """The story deque, with any deferred native records drained
        first so pending story rows materialize before the read."""
        if _NATIVE_PENDING:
            _drain_native_pending()
        return self._transition_log

    def story(self, *keys_or_stimuli: Key) -> list[tuple]:
        """Transition log entries touching any of the given keys/stimuli
        (reference scheduler.py:2915)."""
        keys = set(keys_or_stimuli)
        return [
            t
            for t in self.transition_log
            if t[0] in keys or t[4] in keys or keys & set(t[3])
        ]

    # ------------------------------------------------- transition handlers

    def _transition_released_waiting(self, key: Key, stimulus_id: str) -> tuple[dict, dict, dict]:
        ts = self.tasks[key]
        if self.validate:
            assert ts.run_spec is not None
            assert not ts.waiting_on
            assert not ts.who_has
            assert not ts.processing_on
        recommendations: dict[Key, str] = {}
        for dts in ts.dependencies:
            if dts.state == "forgotten":
                # dependency irrecoverably gone (e.g. scattered data lost)
                ts.state = "erred"  # pragma: no cover
                return recommendations, {}, {}
            # replica truth, not task state: mid-cascade (e.g. worker
            # removal) a dep can be "memory" with an empty who_has while
            # its own released recommendation is still queued — treating
            # it satisfied would place this task with a bare dependency
            # (reference scheduler.py _transition_released_waiting checks
            # who_has)
            if not dts.who_has:
                ts.waiting_on.add(dts)
                if dts.state == "released":
                    recommendations[dts.key] = "waiting"
                elif dts.state == "memory":
                    # last replica vanished while the dep still reads
                    # "memory" (worker-death race): kick its recompute;
                    # if a released rec is already queued in this cascade
                    # the dict merge dedupes it
                    recommendations[dts.key] = "released"
            # register as a waiter on EVERY dependency, satisfied ones
            # included (reference scheduler.py:2110): if an in-memory
            # dep later loses its replicas, _transition_memory_released
            # must find this task in dep.waiters to reschedule it — else
            # it keeps processing against a released dependency
            dts.waiters.add(ts)
        ts.state = "waiting"
        self._count_transition(ts, "released", "waiting")
        if not ts.waiting_on:
            if self.workers:
                recommendations[key] = "processing"
            else:
                self.unrunnable[ts] = self.clock()
                ts.state = "no-worker"
                self._count_transition(ts, "waiting", "no-worker")
        return recommendations, {}, {}

    def _transition_waiting_processing(self, key: Key, stimulus_id: str) -> tuple[dict, dict, dict]:
        """Possibly schedule a waiting task (reference scheduler.py:2313)."""
        ts = self.tasks[key]
        if self.validate:
            assert not ts.waiting_on
            assert not ts.who_has
            assert not ts.exception_blame
            assert not ts.processing_on
        # planned tasks — rootish included: the partitioner co-assigns a
        # tile's SOURCES with the tile, so its inputs are born home
        # instead of round-robined by co-assignment and fetched once per
        # consuming worker
        if (
            self.placement is not None
            and not ts.actor
            and self.placement.wants(ts)
        ):
            verdict, pws = self.placement.resolve(
                self, ts, self._valid_or_running(ts)
            )
            if verdict == "park":
                # defer for the home worker's next slot-open: the
                # task queues scheduler-side and the home worker
                # pulls it via stimulus_queue_slots_maybe_opened
                self.park_task(ts, pws)
                return {ts.key: "queued"}, {}, {}
            if verdict == "hit":
                worker_msgs = self._add_to_processing(ts, pws, stimulus_id)
                self._count_transition(ts, "waiting", "processing")
                return {}, {}, worker_msgs
        if self.is_rootish(ts):
            if math_isfinite(self.WORKER_SATURATION) and ts.queueable:
                if not (ws := self.decide_worker_rootish_queuing_enabled()):
                    return {ts.key: "queued"}, {}, {}
            else:
                if not (ws := self.decide_worker_rootish_queuing_disabled(ts)):
                    return {ts.key: "no-worker"}, {}, {}
        else:
            if not (ws := self.decide_worker_non_rootish(ts)):
                if ts.waiting_on:
                    # A dependency's last replica vanished between the
                    # transition that recommended us and placement (worker
                    # death race); _decide_worker_locality parked us back in
                    # waiting.  Kick recompute of the bare deps instead of
                    # crashing (reference scheduler.py:2247-2250 guards the
                    # equivalent invariant behind validate).
                    # deps already on their way back (a sibling waiter's
                    # reroute, same cascade) must not be cancelled again
                    return (
                        {
                            dts.key: (
                                "waiting" if dts.state == "released" else "released"
                            )
                            for dts in ts.waiting_on
                            if dts.state not in (
                                "waiting", "queued", "no-worker", "processing"
                            )
                        },
                        {},
                        {},
                    )
                return {ts.key: "no-worker"}, {}, {}
        worker_msgs = self._add_to_processing(ts, ws, stimulus_id)
        self._count_transition(ts, "waiting", "processing")
        return {}, {}, worker_msgs

    def _transition_waiting_released(self, key: Key, stimulus_id: str) -> tuple[dict, dict, dict]:
        ts = self.tasks[key]
        recommendations: dict[Key, str] = {}
        # membership guard: an erred dep already cleared its waiters and must
        # not be released/resurrected here (reference scheduler.py:2587-2592)
        for dts in ts.dependencies:
            if ts in dts.waiters:
                dts.waiters.discard(ts)
                if not dts.waiters and not dts.who_wants:
                    recommendations[dts.key] = "released"
        ts.waiting_on.clear()
        ts.state = "released"
        self._count_transition(ts, "waiting", "released")
        if not ts.dependents and not ts.who_wants:
            recommendations[key] = "forgotten"
        elif not ts.exception_blame and (ts.who_wants or ts.waiters):
            recommendations[key] = "waiting"
            for dts in ts.dependencies:
                dts.waiters.add(ts)
        else:
            # not rerunning (reference scheduler.py:2602 clears waiters
            # here).  A WAITING waiter at this point re-registered
            # mid-cascade: an erred-retry hop (erred -> released ->
            # waiting) can resurrect a dependent while our own
            # "released" recommendation is still queued in the same
            # drain — blindly clearing would leave it waiting on a dep
            # that will never run (dangling waiting_on, a liveness
            # hole; hash-order-dependent flake in the mirror churn
            # trace, deterministically pinned by
            # tests/test_races.py::test_waiting_released_reroutes_resurrected_waiters).
            # Reroute it through released: its re-registration then
            # sees our final "released" state and recommends our rerun.
            for dts in ts.waiters:
                if dts.state == "waiting":
                    recommendations[dts.key] = "released"
            ts.waiters.clear()
        return recommendations, {}, {}

    def _transition_waiting_queued(self, key: Key, stimulus_id: str) -> tuple[dict, dict, dict]:
        ts = self.tasks[key]
        if self.validate:
            assert ts not in self.queued
            # rootish tasks queue only when no slot is open anywhere; a
            # PARKED task queues deliberately while other workers have
            # slots — it is waiting for its home worker specifically
            assert not self.idle_task_count or self.is_parked(key), (
                ts, self.idle_task_count,
            )
        ts.state = "queued"
        self._count_transition(ts, "waiting", "queued")
        self.queued.add(ts)
        if key not in self._parked_keys:
            self.queued_unparked.add(ts)
        return {}, {}, {}

    def _transition_waiting_no_worker(self, key: Key, stimulus_id: str) -> tuple[dict, dict, dict]:
        ts = self.tasks[key]
        ts.state = "no-worker"
        self._count_transition(ts, "waiting", "no-worker")
        self.unrunnable[ts] = self.clock()
        return {}, {}, {}

    def _transition_waiting_memory(
        self, key: Key, stimulus_id: str, *, nbytes: int | None = None,
        type: str | None = None, typename: str | None = None, worker: str = "", **kwargs: Any
    ) -> tuple[dict, dict, dict]:
        """Data arrived unexpectedly early (e.g. scatter / AMM replica)."""
        ts = self.tasks[key]
        ws = self.workers.get(worker)
        if ws is None:
            return {}, {}, {}
        recommendations: dict[Key, str] = {}
        client_msgs: dict = {}
        self._remove_from_waiting(ts, recommendations)
        if nbytes is not None:
            self.update_nbytes(ts, nbytes)
        self.add_replica(ts, ws)
        ts.state = "memory"
        ts.type = typename or type
        self._count_transition(ts, "waiting", "memory")
        self._notify_waiters_task_in_memory(ts, recommendations, client_msgs)
        return recommendations, client_msgs, {}

    def _transition_released_memory(
        self, key: Key, stimulus_id: str, *, nbytes: int | None = None,
        typename: str | None = None, worker: str = "", **kwargs: Any,
    ) -> tuple[dict, dict, dict]:
        """Out-of-band data landed (scatter): enter memory through the
        engine so prefix/state accounting stays consistent and waiting
        dependents get recommendations (reference scatter semantics,
        scheduler.py:6103)."""
        ts = self.tasks[key]
        ws = self.workers.get(worker)
        if ws is None:
            return {}, {}, {}
        if nbytes is not None:
            self.update_nbytes(ts, nbytes)
        self.add_replica(ts, ws)
        ts.state = "memory"
        if typename:
            ts.type = typename
        self._count_transition(ts, "released", "memory")
        recommendations: dict[Key, str] = {}
        client_msgs: dict = {}
        self._notify_waiters_task_in_memory(ts, recommendations, client_msgs)
        return recommendations, client_msgs, {}

    def _transition_queued_released(self, key: Key, stimulus_id: str) -> tuple[dict, dict, dict]:
        ts = self.tasks[key]
        self.queued.discard(ts)
        self.queued_unparked.discard(ts)
        self.unpark_task(ts, requeue=False)
        ts.state = "released"
        self._count_transition(ts, "queued", "released")
        recommendations: dict[Key, str] = {}
        self._propagate_released_followup(ts, recommendations)
        return recommendations, {}, {}

    def _transition_queued_processing(self, key: Key, stimulus_id: str) -> tuple[dict, dict, dict]:
        ts = self.tasks[key]
        if self.validate:
            assert not ts.actor, "queued actors not supported"
        pl = self.placement
        if pl is not None and (self.is_parked(key) or pl.wants(ts)):
            # parked/hinted task: re-resolve against live state.  Home
            # slot open -> go home (this stimulus usually IS the home
            # worker freeing a slot).  Still busy within slack -> keep
            # waiting (re-registering in the index: _parked_pop_for pops
            # destructively).  Home gone/overloaded -> resolve falls to
            # hit-elsewhere or miss; on miss take the least busy
            # open-slot worker (queued semantics require an open slot).
            valid = self._valid_or_running(ts)
            verdict, ws = pl.resolve(self, ts, valid)
            if verdict == "park":
                self.park_task(ts, ws)
                return {}, {}, {}
            if verdict != "hit":
                # restriction-aware fallback: the rootish pick ignores
                # valid_workers (safe there — rootish tasks are never
                # restricted), but parked tasks are non-rootish and may
                # carry worker/host/resource restrictions
                cands = [
                    w for w in self.idle_task_count
                    if valid is None or w in valid
                ]
                ws = min(
                    cands,
                    key=lambda w: (len(w.processing) / max(w.nthreads, 1),
                                   w.address),
                    default=None,
                )
        else:
            ws = self.decide_worker_rootish_queuing_enabled()
        if ws is None:
            # nothing can run it right now; it must stay POPPABLE — a
            # destructively-popped parked task left in neither heap would
            # strand forever (no stimulus ever revisits it)
            if not self.is_parked(key) and ts not in self.queued_unparked:
                self.queued_unparked.add(ts)
            return {}, {}, {}  # remain queued
        self.queued.discard(ts)
        self.queued_unparked.discard(ts)
        self.unpark_task(ts, requeue=False)
        worker_msgs = self._add_to_processing(ts, ws, stimulus_id)
        self._count_transition(ts, "queued", "processing")
        return {}, {}, worker_msgs

    def _transition_processing_released(self, key: Key, stimulus_id: str) -> tuple[dict, dict, dict]:
        ts = self.tasks[key]
        ws = ts.processing_on
        if self.validate:
            assert ws is not None
            assert not ts.who_has
            assert not ts.waiting_on
        worker_msgs: dict = {}
        if ws is not None and ws.address in self.workers:
            worker_msgs[ws.address] = [
                {
                    "op": "free-keys",
                    "keys": [key],
                    "stimulus_id": stimulus_id,
                }
            ]
        if ts.ledger_row >= 0:
            # the placement was cancelled mid-flight: no regret to
            # observe, but the row must close (else it ages out as a
            # false unjoined)
            self.ledger.join_row(ts.ledger_row, "released")
            ts.ledger_row = -1
        self._exit_processing_common(ts)
        ts.state = "released"
        self._count_transition(ts, "processing", "released")
        recommendations: dict[Key, str] = {}
        self._propagate_released_followup(ts, recommendations)
        return recommendations, {}, worker_msgs

    def _transition_processing_memory(
        self,
        key: Key,
        stimulus_id: str,
        *,
        nbytes: int | None = None,
        typename: str | None = None,
        worker: str,
        startstops: list | None = None,
        **kwargs: Any,
    ) -> tuple[dict, dict, dict]:
        ts = self.tasks[key]
        assert worker
        ws = ts.processing_on
        if ws is None or ws.address != worker or self.workers.get(worker) is not ws:
            # stale or misrouted completion (reference scheduler.py:2380
            # ignores it outright).  The reporter computed a value this
            # scheduler will never account — an overtaken steal victim,
            # or a pre-partition assignment finishing after the key was
            # re-placed.  Without an answer the reporter holds task +
            # data FOREVER (the forget-time free-keys only reaches
            # who_has members): tell it to drop the unaccounted copy.
            # The native engine's OP_META tape row replays the same
            # message (scheduler/native_engine.py).
            logger.debug("Unexpected finished task %s from %s", key, worker)
            return {}, {}, {worker: [{
                "op": "free-keys", "keys": [key],
                "stimulus_id": stimulus_id,
            }]}
        wws = ws

        # update duration statistics (reference scheduler.py:2366 + _observe)
        realized_compute = 0.0
        if startstops:
            for startstop in startstops:
                if startstop.get("action") == "compute":
                    duration = startstop["stop"] - startstop["start"]
                    realized_compute += duration
                    ts.prefix.add_duration(duration)
                    # the prefix now HAS a measured duration: release
                    # the tasks parked under it at placement time
                    # (reference scheduler.py pops unknown_durations in
                    # _transition_processing_memory).  This dict was
                    # append-only — every TaskState placed before its
                    # prefix's first completion was pinned FOREVER,
                    # with its whole dependency-object cluster: ~10 GB
                    # over a 1M-task simulated run (found by the
                    # sim_10k headline; invisible at test scale).
                    self.unknown_durations.pop(ts.prefix.name, None)
                    ts.group.duration += duration
                    if not ts.group.start:
                        ts.group.start = startstop["start"]
                    ts.group.stop = max(ts.group.stop, startstop["stop"])

        row = ts.ledger_row
        if row >= 0:
            # decision–outcome join (ledger.py): realized compute is the
            # worker-reported duration (clock-agnostic); the join stamp
            # and the decision stamp share THIS engine's clock, so
            # realized total — and therefore regret — is exact under
            # the simulator's virtual time
            ts.ledger_row = -1
            self.ledger.join_row(
                row, "memory", worker, self.clock(),
                realized_compute, self.telemetry,
            )
        self._exit_processing_common(ts)
        if nbytes is not None:
            self.update_nbytes(ts, nbytes)
        self.add_replica(ts, wws)
        ts.state = "memory"
        ts.type = typename
        if typename and ts.group is not None:
            ts.group.types.add(typename)
        self._count_transition(ts, "processing", "memory")

        recommendations: dict[Key, str] = {}
        client_msgs: dict = {}
        self._notify_waiters_task_in_memory(ts, recommendations, client_msgs)
        return recommendations, client_msgs, {}

    def _transition_processing_erred(
        self,
        key: Key,
        stimulus_id: str,
        *,
        worker: str | None = None,
        cause: Key | None = None,
        exception: Any = None,
        traceback: Any = None,
        exception_text: str = "",
        traceback_text: str = "",
        **kwargs: Any,
    ) -> tuple[dict, dict, dict]:
        ts = self.tasks[key]
        failing_ws = ts.processing_on
        if failing_ws is not None:
            if ts.ledger_row >= 0:
                self.ledger.join_row(
                    ts.ledger_row, "erred", worker or "", self.clock(),
                )
                ts.ledger_row = -1
            self._exit_processing_common(ts)
        if self.validate:
            assert cause or ts.exception_blame
        if ts.actor and failing_ws is not None:
            failing_ws.actors.discard(ts)

        recommendations: dict[Key, str] = {}
        client_msgs: dict = {}

        if ts.retries > 0:
            ts.retries -= 1
            ts.state = "released"
            self._count_transition(ts, "processing", "released")
            recommendations[key] = "waiting"
            return recommendations, client_msgs, {}

        if exception is not None:
            # erred state can outlive the wire message indefinitely:
            # compact so the stored frames stop pinning the receive buffer
            ts.exception = compact_frames(exception)
            ts.exception_text = exception_text
        if traceback is not None:
            ts.traceback = compact_frames(traceback)
            ts.traceback_text = traceback_text
        if cause is not None:
            ts.exception_blame = self.tasks.get(cause)
        if worker:
            ts.erred_on.add(worker)
        blame = ts.exception_blame or ts

        for dts in ts.dependents:
            dts.exception_blame = blame
            recommendations[dts.key] = "erred"
        for dts in ts.dependencies:
            dts.waiters.discard(ts)
            if not dts.waiters and not dts.who_wants:
                recommendations[dts.key] = "released"
        ts.waiters.clear()
        ts.state = "erred"
        self._count_transition(ts, "processing", "erred")

        report_msg = {
            "op": "task-erred",
            "key": key,
            "exception": blame.exception,
            "traceback": blame.traceback,
        }
        for cs in ts.who_wants:
            client_msgs.setdefault(cs.client_key, []).append(report_msg)
        self.log_event(
            "all",
            {
                "action": "task-erred",
                "key": key,
                "exception": ts.exception_text,
                "worker": worker,
            },
        )
        return recommendations, client_msgs, {}

    def _transition_released_erred(self, key: Key, stimulus_id: str) -> tuple[dict, dict, dict]:
        ts = self.tasks[key]
        if self.validate:
            assert ts.exception_blame
            assert not ts.who_has
            assert not ts.waiting_on
        recommendations: dict[Key, str] = {}
        client_msgs: dict = {}
        failure = ts.exception_blame
        assert failure is not None
        for dts in ts.dependents:
            if dts.state not in ("erred", "forgotten"):
                dts.exception_blame = failure
                recommendations[dts.key] = "erred"
        report_msg = {
            "op": "task-erred",
            "key": key,
            "exception": failure.exception,
            "traceback": failure.traceback,
        }
        for cs in ts.who_wants:
            client_msgs.setdefault(cs.client_key, []).append(report_msg)
        ts.state = "erred"
        self._count_transition(ts, "released", "erred")
        return recommendations, client_msgs, {}

    def _transition_erred_released(self, key: Key, stimulus_id: str) -> tuple[dict, dict, dict]:
        ts = self.tasks[key]
        ts.exception = None
        ts.exception_blame = None
        ts.traceback = None
        # build free-keys messages before clearing the erred_on record
        w_msg = {"op": "free-keys", "keys": [key], "stimulus_id": stimulus_id}
        worker_msgs = {addr: [w_msg] for addr in ts.erred_on if addr in self.workers}
        ts.erred_on.clear()
        recommendations: dict[Key, str] = {}
        client_msgs: dict = {}
        for dts in ts.dependents:
            if dts.state == "erred":
                recommendations[dts.key] = "waiting"
        report_msg = {"op": "task-retried", "key": key}
        for cs in ts.who_wants:
            client_msgs.setdefault(cs.client_key, []).append(report_msg)
        ts.state = "released"
        self._count_transition(ts, "erred", "released")
        return recommendations, client_msgs, worker_msgs

    def _transition_no_worker_released(self, key: Key, stimulus_id: str) -> tuple[dict, dict, dict]:
        ts = self.tasks[key]
        del self.unrunnable[ts]
        ts.state = "released"
        self._count_transition(ts, "no-worker", "released")
        recommendations: dict[Key, str] = {}
        self._propagate_released_followup(ts, recommendations)
        return recommendations, {}, {}

    def _transition_no_worker_erred(self, key: Key, stimulus_id: str) -> tuple[dict, dict, dict]:
        """no-workers-timeout expiry: unsatisfiable restrictions fail the
        task instead of parking it forever (reference no-workers-timeout)."""
        ts = self.tasks[key]
        del self.unrunnable[ts]
        recommendations: dict[Key, str] = {}
        # deregister from dependencies exactly like processing->erred:
        # the failed task must not pin its (possibly in-memory) deps
        for dts in ts.dependencies:
            dts.waiters.discard(ts)
            if not dts.waiters and not dts.who_wants:
                recommendations[dts.key] = "released"
        # a bare-dep reroute can park a no-worker task with waiting_on
        # set; released->erred asserts it empty under validate
        for dts in list(ts.waiting_on):
            dts.waiters.discard(ts)
        ts.waiting_on.clear()
        ts.state = "released"
        self._count_transition(ts, "no-worker", "released")
        recs2, client_msgs, worker_msgs = self._transition_released_erred(
            key, stimulus_id
        )
        recommendations.update(recs2)
        return recommendations, client_msgs, worker_msgs

    def _transition_no_worker_processing(self, key: Key, stimulus_id: str) -> tuple[dict, dict, dict]:
        ts = self.tasks[key]
        if ws := self.decide_worker_non_rootish(ts):
            del self.unrunnable[ts]
            worker_msgs = self._add_to_processing(ts, ws, stimulus_id)
            self._count_transition(ts, "no-worker", "processing")
            return {}, {}, worker_msgs
        if ts.waiting_on:
            # bare-dep reroute (see _transition_waiting_processing): move back
            # to waiting and recompute the deps whose replicas vanished —
            # skipping deps already on their way back (same filter as the
            # waiting-path branch: a sibling's reroute must not cancel an
            # in-flight recompute)
            del self.unrunnable[ts]
            ts.state = "waiting"
            self._count_transition(ts, "no-worker", "waiting")
            return (
                {
                    dts.key: (
                        "waiting" if dts.state == "released" else "released"
                    )
                    for dts in ts.waiting_on
                    if dts.state not in (
                        "waiting", "queued", "no-worker", "processing"
                    )
                },
                {},
                {},
            )
        return {}, {}, {}

    def _transition_memory_released(
        self, key: Key, stimulus_id: str, *, safe: bool = False
    ) -> tuple[dict, dict, dict]:
        ts = self.tasks[key]
        if self.validate:
            assert not ts.waiting_on
            assert not ts.processing_on
            if safe:
                assert not ts.waiters
        if ts.actor:
            for ws in ts.who_has:
                ws.actors.discard(ts)
            if ts.who_wants:
                ts.exception_blame = ts
                ts.exception = "Worker holding Actor was lost"
                return {ts.key: "erred"}, {}, {}

        recommendations: dict[Key, str] = {}
        client_msgs: dict = {}
        worker_msgs: dict = {}
        # dependents that were waiting on us must go back to waiting
        for dts in ts.waiters:
            if dts.state in ("no-worker", "processing", "queued"):
                recommendations[dts.key] = "waiting"
            elif dts.state == "waiting":
                dts.waiting_on.add(ts)
        # free replicas on all workers
        freed = [ws.address for ws in ts.who_has]
        for ws in list(ts.who_has):
            self.remove_replica(ts, ws)
        for addr in freed:
            if addr in self.workers:
                worker_msgs.setdefault(addr, []).append(
                    {"op": "free-keys", "keys": [key], "stimulus_id": stimulus_id}
                )
        ts.state = "released"
        self._count_transition(ts, "memory", "released")
        report_msg = {"op": "lost-data", "key": key}
        for cs in ts.who_wants:
            client_msgs.setdefault(cs.client_key, []).append(report_msg)
        if not ts.run_spec:  # pure data (scatter) — cannot be recomputed
            recommendations[key] = "forgotten"
        elif not ts.exception_blame and (ts.who_wants or ts.waiters):
            # exception_blame guard: a task being routed memory->erred
            # (e.g. shuffle restart-budget exhaustion) must not be
            # resurrected here — the composed transition would let this
            # "waiting" override the "erred" target
            recommendations[key] = "waiting"
        if recommendations.get(key) == "waiting":
            for dts in ts.dependencies:
                dts.waiters.add(ts)
        else:
            self._deregister_waiter(ts, recommendations)
        return recommendations, client_msgs, worker_msgs

    def _transition_released_forgotten(self, key: Key, stimulus_id: str) -> tuple[dict, dict, dict]:
        ts = self.tasks[key]
        if self.validate:
            assert ts.state in ("released", "erred")
            assert not ts.who_has
            assert not ts.processing_on
            assert not ts.waiting_on
            # pure data (scatter) may be forgotten while dependents
            # remain: it cannot be recomputed, so holding the record
            # preserves nothing — the reference allows exactly this
            # ("It's ok to forget a pure data task", scheduler.py
            # _transition_released_forgotten).  Found by the simulator's
            # scatter -> consume -> client-release flow under validate.
            if ts.run_spec is not None:
                assert not any(
                    dts.state != "forgotten" for dts in ts.dependents
                ), (ts, [d for d in ts.dependents if d.state != "forgotten"])
        recommendations: dict[Key, str] = {}
        self._propagate_forgotten(ts, recommendations)
        client_msgs = self._task_erred_or_forgotten_report(ts)
        self.remove_all_replicas(ts)
        self._remove_task(ts)
        return recommendations, client_msgs, {}

    def _transition_memory_forgotten(self, key: Key, stimulus_id: str) -> tuple[dict, dict, dict]:
        ts = self.tasks[key]
        if self.validate:
            assert ts.state == "memory"
            assert not ts.processing_on
            assert not ts.waiting_on
        recommendations: dict[Key, str] = {}
        worker_msgs: dict = {}
        for ws in ts.who_has:
            worker_msgs.setdefault(ws.address, []).append(
                {"op": "free-keys", "keys": [key], "stimulus_id": stimulus_id}
            )
        self._propagate_forgotten(ts, recommendations)
        client_msgs = self._task_erred_or_forgotten_report(ts)
        self.remove_all_replicas(ts)
        self._remove_task(ts)
        return recommendations, client_msgs, worker_msgs

    # --------------------------------------------- transition helper pieces

    def _count_transition(self, ts: TaskState, start: str, finish: str) -> None:
        if ts.group is not None:
            ts.group.states[start] -= 1
            ts.group.states[finish] += 1
        if ts.prefix is not None:
            ts.prefix.state_counts[finish] += 1

    def _propagate_released_followup(self, ts: TaskState, recommendations: dict) -> None:
        """After a task lands in released: rerun, or forget, or stay."""
        if not ts.dependents and not ts.who_wants:
            recommendations[ts.key] = "forgotten"
        elif not ts.exception_blame and (ts.who_wants or ts.waiters):
            recommendations[ts.key] = "waiting"
            for dts in ts.dependencies:
                dts.waiters.add(ts)
        else:
            # staying released (nobody reruns us): deregister as a waiter
            # so finished deps can be collected — tasks register on EVERY
            # dep at scheduling time (released->waiting), so without this
            # a released-for-good task pins its deps in memory forever
            self._deregister_waiter(ts, recommendations)

    def _deregister_waiter(self, ts: TaskState, recommendations: dict) -> None:
        for dts in ts.dependencies:
            if ts in dts.waiters:
                dts.waiters.discard(ts)
                if not dts.waiters and not dts.who_wants:
                    recommendations[dts.key] = "released"

    def _remove_from_waiting(self, ts: TaskState, recommendations: dict) -> None:
        for dts in ts.waiting_on:
            dts.waiters.discard(ts)
            if not dts.waiters and not dts.who_wants:
                recommendations[dts.key] = "released"
        ts.waiting_on.clear()

    def _notify_waiters_task_in_memory(
        self, ts: TaskState, recommendations: dict, client_msgs: dict
    ) -> None:
        """Task hit memory: unblock waiters, report to clients, release
        no-longer-needed dependencies (reference scheduler.py:2366 tail)."""
        for dts in list(ts.dependents):
            if ts in dts.waiting_on:
                dts.waiting_on.discard(ts)
                if not dts.waiting_on and dts.state == "waiting":
                    recommendations[dts.key] = "processing"
        for dts in ts.dependencies:
            dts.waiters.discard(ts)
            if not dts.waiters and not dts.who_wants:
                recommendations[dts.key] = "released"
        if not ts.waiters and not ts.who_wants:
            recommendations[ts.key] = "released"
        else:
            report_msg = {
                "op": "key-in-memory",
                "key": ts.key,
                "type": ts.type,
            }
            for cs in ts.who_wants:
                client_msgs.setdefault(cs.client_key, []).append(report_msg)

    def _task_erred_or_forgotten_report(self, ts: TaskState) -> dict:
        client_msgs: dict = {}
        if ts.who_wants:
            report_msg = {"op": "cancelled-keys", "keys": [ts.key]}
            for cs in ts.who_wants:
                client_msgs.setdefault(cs.client_key, []).append(report_msg)
        return client_msgs

    def _propagate_forgotten(self, ts: TaskState, recommendations: dict) -> None:
        self._count_transition(ts, ts.state, "forgotten")
        ts.state = "forgotten"
        for dts in ts.dependents:
            dts.dependencies.discard(ts)
            dts.waiting_on.discard(ts)
        ts.dependents.clear()
        ts.waiters.clear()
        for dts in ts.dependencies:
            dts.dependents.discard(ts)
            dts.waiters.discard(ts)
            if not dts.dependents and not dts.who_wants:
                recommendations[dts.key] = "forgotten"
        ts.dependencies.clear()
        ts.waiting_on.clear()

    def _remove_task(self, ts: TaskState) -> None:
        if ts.group is not None:
            tg = ts.group
            tg.n_tasks -= 1
            if tg.n_tasks <= 0:
                self.task_groups.pop(tg.name, None)
                if tg.prefix is not None:
                    tg.prefix.groups.discard(tg)
        for cs in list(ts.who_wants):
            cs.wants_what.discard(ts)
        ts.who_wants.clear()
        self.tasks.pop(ts.key, None)
        if self.native is not None:
            self.native.on_forget_task(ts)
        if self.durability is not None:
            self.durability.on_remove_task(ts)

    def _exit_processing_common(self, ts: TaskState) -> None:
        """Remove from processing_on worker and fix occupancy
        (reference _exit_processing_common scheduler.py:3264)."""
        ws = ts.processing_on
        assert ws is not None
        # stealing's confirm path calls this OUTSIDE a _transition, so
        # the SoA mark cannot ride the _transition funnel
        if self.native is not None:
            self.native.mark_task(ts)
        if self.durability is not None:
            self.durability.mark_replica(ts, ws)
        ts.processing_on = None
        ts.homed = False
        duration = ws.processing.pop(ts, 0.0)
        was_long_running = ts in ws.long_running
        ws.long_running.discard(ts)
        ws.executing.pop(ts, None)
        if not was_long_running:
            self._adjust_occupancy(ws, -duration)
        if not ws.processing:
            self._total_occupancy -= ws.occupancy
            ws.occupancy = 0.0
        if ts.resource_restrictions:
            for r, quantity in ts.resource_restrictions.items():
                if r in ws.used_resources:
                    ws.used_resources[r] -= quantity
        self.check_idle_saturated(ws)

    def _add_to_processing(
        self, ts: TaskState, ws: WorkerState, stimulus_id: str,
        kind: str | None = None,
    ) -> dict:
        """Assign ts to ws (reference scheduler.py:3199).

        ``kind`` labels the decision in the ledger (``steal`` /
        ``steal-spec`` from the stealing extension); ``None`` derives
        ``plan`` for jax_placement plan homes and ``placement``
        otherwise."""
        if self.validate:
            assert not ts.waiting_on
            assert not ts.who_has
            assert not ts.exception_blame
            assert not ts.processing_on
            assert ws in self.running, (ws, ts)
        duration = self.get_task_duration(ts)
        comm = self.get_comm_cost(ts, ws)
        # shadow divergence monitor (read-only): this is THE placement
        # decision — record what the measured model would have priced
        self.shadow_comm_cost(ts, ws, comm, "placement", stimulus_id)
        led = self.ledger
        if led.enabled:
            if ts.dependencies or (kind is None and ts.homed):
                # dep-bearing (link pricing) or homed (plan/pin kind
                # derivation incl. plan_stim): the full filing helper
                self.ledger_file_decision(ts, ws, stimulus_id, kind,
                                          duration, comm)
            else:
                # dep-free fast path, inlined: no links to price, both
                # models predict 0 transfer — the row carries identity
                # + the duration prediction only
                prefix = ts.prefix
                ts.ledger_row = led.file(
                    kind if kind is not None else "placement", ts.key,
                    prefix.name if prefix is not None else "",
                    ws.address, stimulus_id, comm, comm, False,
                    0, 0, duration, "", "",
                    supersede=ts.ledger_row,
                )
        # stealing's re-placement calls this OUTSIDE a _transition (see
        # _exit_processing_common); the mark must not depend on the
        # _transition funnel
        if self.native is not None:
            self.native.mark_task(ts)
        if self.durability is not None:
            self.durability.mark_replica(ts, ws)
        ws.processing[ts] = duration + comm
        ts.processing_on = ws
        ts.state = "processing"
        # occupancy is booked in raw seconds of queued work; consumers divide
        # by nthreads once at compare time (reference scheduler.py:3140)
        self._adjust_occupancy(ws, duration + comm)
        if ts.resource_restrictions:
            for r, quantity in ts.resource_restrictions.items():
                ws.used_resources[r] = ws.used_resources.get(r, 0) + quantity
        if ts.actor:
            ws.actors.add(ts)
        self.check_idle_saturated(ws)
        return {ws.address: [self._task_to_msg(ts, stimulus_id)]}

    def _task_to_msg(self, ts: TaskState, stimulus_id: str) -> dict:
        """Build the compute-task message (reference scheduler.py:3421).

        ``run_spec`` arrived from the client as an opaque wrapper
        (``Serialize`` over inproc, ``Serialized`` frames over tcp —
        the scheduler runs deserialize=False) and is forwarded to the
        worker verbatim: no unpickle/repickle on the scheduler, and no
        user code needed here (reference scheduler.py:3438).  Raw specs
        (internal callers, tests) are wrapped so they cross tcp pickled.
        """
        assert ts.priority is not None
        return {
            "op": "compute-task",
            "key": ts.key,
            "priority": ts.priority,
            "stimulus_id": stimulus_id,
            "who_has": {
                dts.key: [wws.address for wws in dts.who_has] for dts in ts.dependencies
            },
            "nbytes": {dts.key: dts.nbytes for dts in ts.dependencies},
            "run_spec": wrap_opaque(ts.run_spec),
            "duration": self.get_task_duration(ts),
            "resource_restrictions": ts.resource_restrictions,
            "actor": ts.actor,
            "annotations": ts.annotations or {},
            "span_id": ts.group.span_id if ts.group else None,
        }

    # ------------------------------------------------------- cost model

    def get_task_duration(self, ts: TaskState) -> float:
        """Estimated runtime (reference scheduler.py:2986)."""
        prefix = ts.prefix
        duration = prefix.duration_average if prefix is not None else -1.0
        if duration >= 0:
            return duration
        if prefix is not None:
            s = self.unknown_durations.setdefault(prefix.name, set())
            s.add(ts)
        return self.UNKNOWN_TASK_DURATION

    def get_comm_cost(self, ts: TaskState, ws: WorkerState) -> float:
        """Bytes that must move to run ts on ws, over bandwidth
        (reference scheduler.py:3003)."""
        if len(ts.dependencies) < 10:
            deps = [dts for dts in ts.dependencies if ws not in dts.who_has]
        else:
            deps = [
                dts for dts in ts.dependencies.difference(ws.has_what)
            ]
        nbytes = sum(dts.get_nbytes() for dts in deps)
        return nbytes / self.bandwidth + len(deps) * self.transfer_latency

    def get_comm_cost_measured(
        self, ts: TaskState, ws: WorkerState
    ) -> tuple[float, bool]:
        """The measured-model twin of :meth:`get_comm_cost` — same
        shape (missing-dep bytes over bandwidth plus a per-dep fixed
        cost) with per-link MEASURED inputs where the telemetry plane
        has them (telemetry.py):

        - bandwidth: the best (highest-EWMA) measured link from any of
          the dep's holders to ``ws`` — the optimistic achievable
          fetch, matching gather's freedom to pick any holder;
        - fixed cost: that link's residual-latency EWMA, else the
          worker's heartbeat-RTT EWMA, else ``transfer_latency``;
        - constant fallback for links never observed.

        Returns ``(cost, used_measured)`` — the flag marks whether any
        measured link actually priced a dep (a pure-fallback cost says
        nothing about the constants).  READ-ONLY shadow: no decision
        path consults this (ROADMAP item 3 swaps the inputs later).
        """
        tel = self.telemetry
        rtt = tel.rtt.get(ws.address, 0.0)
        total = 0.0
        used_measured = False
        for dts in ts.dependencies:
            if ws in dts.who_has:
                continue
            nb = dts.get_nbytes()
            best_bw = 0.0
            best_lat = -1.0
            for hws in dts.who_has:
                link = tel.links.get((hws.address, ws.address))
                if link is not None and link.bandwidth.count:
                    bw = link.bandwidth.value
                    if bw > best_bw:
                        best_bw = bw
                        best_lat = link.latency.value
            if best_bw > 0.0:
                used_measured = True
                total += nb / best_bw + best_lat
            elif rtt > 0.0:
                # unseen link, but the fleet's control-plane RTT is
                # measured: constant bandwidth + measured fixed cost
                used_measured = True
                total += nb / self.bandwidth + rtt
            else:
                total += nb / self.bandwidth + self.transfer_latency
        return total, used_measured

    def shadow_comm_cost(self, ts: TaskState, ws: WorkerState,
                         constant: float | None, site: str,
                         stimulus_id: str) -> None:
        """Shadow cost-model divergence monitor: next to a decision that
        just priced ``ts`` on ``ws`` with the CONSTANT model, compute
        the measured model and record ``measured / constant`` in the
        ``dtpu_costmodel_divergence_ratio`` histogram plus a sampled
        flight-recorder ``shadow`` event carrying the stimulus id — so
        Perfetto shows which decisions the constants are lying about.
        Zero behavior change: callers already made their decision.

        Pass ``constant=None`` from callers that did NOT already
        compute the constant cost for their own use — it is then
        computed here, BEHIND the enabled/sampling gates, so a
        disabled or sampled-out eval costs two attribute reads."""
        tel = self.telemetry
        if not tel.enabled or not tel.tick_divergence():
            return
        if constant is None:
            constant = self.get_comm_cost(ts, ws)
        measured, used_measured = self.get_comm_cost_measured(ts, ws)
        ratio = tel.observe_divergence(constant, measured, used_measured)
        self.trace.emit_task(
            "shadow", site, stimulus_id, key=ts.key,
            n=int(ratio * 1000), dest=ws.address,
        )

    # --------------------------------------------- decision ledger filing

    def ledger_file_decision(self, ts: TaskState, ws: WorkerState,
                             stimulus_id: str, kind: str | None,
                             duration: float, comm: float,
                             now: float | None = None) -> None:
        """File one task-cost decision row (ledger.py): the prediction
        half — constant comm cost, the measured shadow's price, the
        missing-dep byte total, and the dominant dep link (best holder
        of the heaviest missing dep).  The realized half joins when the
        task reaches memory/erred (docs/observability.md).  ``now``
        carries the flood-hoisted decision stamp when the native engine
        replays deferred tape rows (the ledger digest folds it, so the
        stamp must match what the eager path would have read)."""
        dep_bytes = 0
        n_deps = 0
        src = ""
        measured, used = comm, False
        if ts.dependencies:
            heaviest = -1
            for dts in ts.dependencies:
                if ws in dts.who_has:
                    continue
                nb = dts.get_nbytes()
                dep_bytes += nb
                n_deps += 1
                if nb > heaviest:
                    heaviest = nb
                    for hws in dts.who_has:
                        src = hws.address
                        break
            if n_deps:
                tel = self.telemetry
                if tel.enabled and (tel.links or tel.rtt):
                    measured, used = self.get_comm_cost_measured(ts, ws)
                # else: nothing measured yet — the measured model falls
                # back to the constants dep-for-dep, so its price IS
                # ``comm``; skip the recompute on the flood hot path
        plan_stim = ""
        if kind is None:
            if ts.homed == "plan":
                # a jax_placement plan home — NOT a shuffle "pin"
                # (ts.homed carries the provenance): stamp the landed
                # plan's stimulus so the row joins its kernel event
                kind = "plan"
                if self.placement is not None:
                    plan_stim = getattr(self.placement, "plan_stim", "")
            else:
                kind = "placement"
        prefix = ts.prefix
        ts.ledger_row = self.ledger.file(
            kind, ts.key, prefix.name if prefix is not None else "",
            ws.address, stimulus_id, comm, measured, used,
            dep_bytes, n_deps, duration, src, plan_stim,
            supersede=ts.ledger_row, now=now,
        )

    def get_replica_cost_measured(
        self, ts: TaskState, ws: WorkerState
    ) -> tuple[float, bool]:
        """Measured transfer price for moving ``ts``'s own payload to
        ``ws`` (the AMM replica decision's cost): best measured holder
        link, RTT fallback, constant fallback — the replica twin of
        :meth:`get_comm_cost_measured`'s per-dep pricing."""
        tel = self.telemetry
        nb = ts.get_nbytes()
        best_bw = 0.0
        best_lat = -1.0
        for hws in ts.who_has:
            link = tel.links.get((hws.address, ws.address))
            if link is not None and link.bandwidth.count:
                bw = link.bandwidth.value
                if bw > best_bw:
                    best_bw = bw
                    best_lat = link.latency.value
        if best_bw > 0.0:
            return nb / best_bw + best_lat, True
        rtt = tel.rtt.get(ws.address, 0.0)
        if rtt > 0.0:
            return nb / self.bandwidth + rtt, True
        return nb / self.bandwidth + self.transfer_latency, False

    def worker_objective(self, ts: TaskState, ws: WorkerState) -> tuple:
        """Lower is better (reference scheduler.py:3131 — plus a fixed
        per-missing-dep latency term the reference lacks: with tiny
        chunks, bytes/bandwidth alone calls transfers free and the
        objective degenerates to load-balancing, scattering reduction
        trees and drowning the loop in gather_dep RPCs)."""
        n_missing = 0
        dep_bytes = 0
        for dts in ts.dependencies:
            if ws not in dts.who_has:
                n_missing += 1
                dep_bytes += dts.get_nbytes()
        stack_time = (
            ws.occupancy / max(ws.nthreads, 1)
            + dep_bytes / self.bandwidth
            + n_missing * self.transfer_latency
        )
        start_time = stack_time + self.get_task_duration(ts)
        if ts.actor:
            return (len(ws.actors), start_time, ws.nbytes)
        return (start_time, ws.nbytes)

    # ------------------------------------------------------- placement

    def observe_engine_shards(self, shards: list[dict]) -> None:
        """Fold one sharded plan's per-shard stats (from
        ``ops/leveled.place_graph_leveled_sharded``) into the
        /metrics-facing aggregates: kernel ms is last-plan, H2D bytes
        and plan count accumulate."""
        if len(self.engine_shards) != len(shards):
            self.engine_shards = [
                {"kernel_ms": 0.0, "h2d_bytes": 0, "plans": 0}
                for _ in shards
            ]
        for agg, s in zip(self.engine_shards, shards):
            agg["kernel_ms"] = float(s.get("kernel_ms", 0.0))
            agg["h2d_bytes"] += int(s.get("h2d_bytes", 0))
            agg["plans"] += 1

    def is_rootish(self, ts: TaskState) -> bool:
        """Root-ish: a task in a large group with few deps
        (reference scheduler.py:2929)."""
        if ts._rootish is not None:
            return ts._rootish
        if ts.resource_restrictions or ts.worker_restrictions or ts.host_restrictions:
            return False
        tg = ts.group
        if tg is None:
            return False
        return (
            len(tg) > self.total_nthreads * 2
            and len(tg.dependencies) < 5
            and sum(map(len, tg.dependencies)) < 5
        )

    def decide_worker_rootish_queuing_disabled(self, ts: TaskState) -> WorkerState | None:
        """Co-assign sibling root tasks to the same worker
        (reference scheduler.py:2135)."""
        assert ts.group is not None
        tg = ts.group
        lws = tg.last_worker
        if not (lws and tg.last_worker_tasks_left and lws.address in self.workers
                and lws.status == WORKER_STATUS_RUNNING):
            # pick the least-occupied running worker
            lws = min(
                self.running,
                key=lambda ws: (len(ws.processing) / max(ws.nthreads, 1), ws.nbytes, ws.address),
                default=None,
            )
            if lws is None:
                return None
            tg.last_worker_tasks_left = len(tg) // max(len(self.running), 1) or 1
        tg.last_worker = lws
        tg.last_worker_tasks_left -= 1
        if tg.last_worker_tasks_left == 0:
            tg.last_worker = None
        return lws

    def decide_worker_rootish_queuing_enabled(self) -> WorkerState | None:
        """Least-busy idle worker, or None to queue
        (reference scheduler.py:2195)."""
        if not self.idle_task_count:
            return None
        ws = min(
            self.idle_task_count,
            key=lambda ws: (len(ws.processing) / max(ws.nthreads, 1), ws.address),
        )
        if self.validate:
            assert not _worker_full(ws, self.WORKER_SATURATION), (ws, self.WORKER_SATURATION)
        return ws

    def _valid_or_running(self, ts: TaskState) -> set[WorkerState] | None:
        """Restriction set for placement decisions; running-only when
        some workers are paused (same narrowing as decide_worker_non_rootish)."""
        valid_workers = self.valid_workers(ts)
        if valid_workers is None and len(self.running) < len(self.workers):
            valid_workers = self.running
        return valid_workers

    def decide_worker_non_rootish(self, ts: TaskState) -> WorkerState | None:
        """Place by data locality + occupancy (reference scheduler.py:2247, 8550)."""
        if not self.running:
            return None
        valid_workers = self._valid_or_running(ts)
        if self.placement is not None and self.placement.wants(ts):
            ws = self.placement.decide_worker(self, ts, valid_workers)
            if ws is not None:
                return ws
        return self._decide_worker_locality(ts, valid_workers)

    def _decide_worker_locality(
        self, ts: TaskState, valid_workers: set[WorkerState] | None
    ) -> WorkerState | None:
        """The python oracle for decide_worker (reference scheduler.py:8550).

        A dependency may lose its last replica between the transition that
        recommended this placement and the placement itself (worker death
        races).  The reference guards the invariant check behind ``validate``
        (reference scheduler.py:2247-2250); in production we reroute the
        bare dependency through ``released`` instead of crashing.
        """
        if self.validate:
            assert all(dts.who_has for dts in ts.dependencies), (
                ts,
                [d for d in ts.dependencies if not d.who_has],
            )
        bare = [dts for dts in ts.dependencies if not dts.who_has]
        if bare:
            # Replica vanished in a race: park this task back in waiting on
            # the bare deps; _transition_waiting_processing kicks recompute.
            for dts in bare:
                ts.waiting_on.add(dts)
                dts.waiters.add(ts)
            return None
        if ts.actor:
            candidates = set(self.running)
        else:
            candidates = {ws for dts in ts.dependencies for ws in dts.who_has}
            candidates &= self.running
        if valid_workers is None:
            if not candidates:
                candidates = set(self.running)
        else:
            candidates &= valid_workers
            if not candidates:
                candidates = valid_workers & self.running
                if not candidates:
                    if ts.loose_restrictions:
                        return self._decide_worker_locality(ts, None)
                    return None
        if not candidates:
            return None
        if len(candidates) == 1:
            return next(iter(candidates))
        return min(
            candidates, key=lambda ws: self.worker_objective(ts, ws) + (ws.address,)
        )

    def valid_workers(self, ts: TaskState) -> set[WorkerState] | None:
        """Workers satisfying ts's restrictions; None = all
        (reference scheduler.py:3043)."""
        if not ts.has_restrictions:
            return None
        s: set[WorkerState] | None = None
        if ts.worker_restrictions:
            s = {
                self.workers[addr]
                for addr in ts.worker_restrictions
                if addr in self.workers
            }
        if ts.host_restrictions:
            hosts = {
                ws
                for ws in self.workers.values()
                if ws.address.rsplit(":", 1)[0].split("://")[-1] in ts.host_restrictions
                or str(ws.name) in ts.host_restrictions
            }
            s = hosts if s is None else s & hosts
        if ts.resource_restrictions:
            # filter by total SUPPLY, not currently-free amount (reference
            # scheduler.py:3043 checks self.resources supply): the worker
            # state machine serializes execution against its available
            # resources, so oversubscribed processing just queues there.
            # Filtering by free amount sends later tasks to "no-worker"
            # with nothing to ever wake them once the resource frees.
            res_ok = {
                ws
                for ws in self.workers.values()
                if all(
                    ws.resources.get(r, 0) >= q
                    for r, q in ts.resource_restrictions.items()
                )
            }
            s = res_ok if s is None else s & res_ok
        return s if s is not None else set()

    # ------------------------------------------------ idle/saturated model

    def check_idle_saturated(self, ws: WorkerState, occ: float | None = None) -> None:
        """Update the idle/saturated sets (reference scheduler.py:2949)."""
        # callers reach here after any occupancy/processing change, so
        # this is the mirror's cheapest single choke point — mark before
        # the early return (the return skips set updates, not mutations
        # the caller already made)
        if self.mirror is not None:
            self.mirror.mark(ws)
        if self.native is not None:
            self.native.mark_worker(ws)
        if self.total_nthreads == 0 or ws.status == WORKER_STATUS_CLOSED:
            return
        if occ is None:
            occ = ws.occupancy
        p = len(ws.processing)
        avg = self.total_occupancy / self.total_nthreads if self.total_nthreads else 0

        idle = self.idle
        saturated = self.saturated
        if (p < ws.nthreads or occ < ws.nthreads * avg / 2) and ws.status == WORKER_STATUS_RUNNING:
            idle[ws.address] = ws
            saturated.discard(ws)
        else:
            idle.pop(ws.address, None)
            nc = ws.nthreads
            if p > nc and occ > nc * avg:
                saturated.add(ws)
            else:
                saturated.discard(ws)

        if not _worker_full(ws, self.WORKER_SATURATION) and ws.status == WORKER_STATUS_RUNNING:
            self.idle_task_count.add(ws)
        else:
            self.idle_task_count.discard(ws)

    @property
    def total_occupancy(self) -> float:
        return self._total_occupancy

    def _adjust_occupancy(self, ws: WorkerState, delta: float) -> None:
        ws.occupancy = max(0.0, ws.occupancy + delta)
        self._total_occupancy = max(0.0, self._total_occupancy + delta)
        if self.mirror is not None:
            self.mirror.mark(ws)
        if self.native is not None:
            self.native.mark_worker(ws)

    def _task_slots_available(self, ws: WorkerState) -> int:
        """Open slots below the saturation threshold (reference scheduler.py:8762)."""
        if ws.status != WORKER_STATUS_RUNNING:
            return 0
        return max(
            math_ceil(ws.nthreads * self.WORKER_SATURATION) - len(ws.processing), 0
        )

    # ------------------------------------------------------- parked tasks

    def park_task(self, ts: TaskState, ws: WorkerState) -> None:
        """Register a queued task as waiting for ws's next slot-open.
        Parked tasks live in ``queued`` (state invariants) but NOT in
        ``queued_unparked`` (global pops)."""
        heap = self.parked.get(ws.address)
        if heap is None:
            heap = self.parked[ws.address] = HeapSet(
                key=lambda t: t.priority
            )
        heap.add(ts)
        self._parked_keys[ts.key] = ws.address
        self.queued_unparked.discard(ts)

    def unpark_task(self, ts: TaskState, requeue: bool = True) -> None:
        """Drop park bookkeeping; re-enter global pops when ``requeue``
        (leaving-queued callers pass False)."""
        addr = self._parked_keys.pop(ts.key, None)
        if addr is not None:
            heap = self.parked.get(addr)
            if heap is not None:
                heap.discard(ts)
                if not heap:
                    del self.parked[addr]
            if requeue and ts.state == "queued":
                self.queued_unparked.add(ts)

    def is_parked(self, key: Key) -> bool:
        return key in self._parked_keys

    def splice_parked(self, address: str) -> None:
        """Return every task parked for ``address`` to the global pop
        heap — the home can no longer pull (paused / removed / dead)."""
        heap = self.parked.pop(address, None)
        if heap is not None:
            for ts in list(heap):
                self._parked_keys.pop(ts.key, None)
                if ts.state == "queued":
                    self.queued_unparked.add(ts)

    def _parked_pop_for(self, ws: WorkerState, n: int) -> list[TaskState]:
        """Up to n parked tasks for ws, best priority first — DESTRUCTIVE
        (the queued->processing transition re-parks any that must keep
        waiting), so repeatedly-scanned stale entries never build up."""
        heap = self.parked.get(ws.address)
        if heap is None:
            return []
        out: list[TaskState] = []
        while heap and len(out) < n:
            ts = heap.pop()
            self._parked_keys.pop(ts.key, None)
            if ts.state == "queued":
                out.append(ts)
        if not heap:
            self.parked.pop(ws.address, None)
        return out

    def stimulus_queue_slots_maybe_opened(self, stimulus_id: str) -> dict[Key, str]:
        """Pop exactly as many queued tasks as there are open slots
        (reference scheduler.py:4983).

        Each open-slot worker first pulls tasks PARKED for it (the
        placement plan's co-assignment, pulled past the slot line so the
        worker pipeline never drains between stimuli); the global
        priority order over non-parked tasks fills what remains."""
        if not self.queued:
            return {}
        recs: dict[Key, str] = {}
        slots = 0
        if self._parked_keys:
            for ws in self.idle_task_count:
                s = self._task_slots_available(ws)
                slots += s
                if ws.address in self.parked:
                    for ts in self._parked_pop_for(ws, s + ws.nthreads):
                        recs[ts.key] = "processing"
        else:
            slots = sum(
                self._task_slots_available(ws) for ws in self.idle_task_count
            )
        remaining = slots - len(recs)
        if remaining > 0 and self.queued_unparked:
            for ts in self.queued_unparked.peekn(remaining):
                recs[ts.key] = "processing"
        return recs

    def stimulus_no_workers_timeout(
        self, timeout: float, stimulus_id: str
    ) -> tuple[dict, dict]:
        """Fail tasks stuck in no-worker longer than ``timeout``
        (reference scheduler.no-workers-timeout): their restrictions
        cannot be satisfied by the current fleet, and waiting forever
        hides the misconfiguration from the client."""
        now = self.clock()
        recs: dict[Key, str] = {}
        for ts, since in list(self.unrunnable.items()):
            if now - since <= timeout:
                continue
            exc = NoValidWorkerError(
                ts.key,
                worker_restrictions=sorted(ts.worker_restrictions)
                if ts.worker_restrictions else None,
                resource_restrictions=dict(ts.resource_restrictions)
                if ts.resource_restrictions else None,
            )
            ts.exception = exc
            ts.exception_text = (
                f"no running worker satisfies the restrictions of "
                f"{ts.key!r} within the no-workers-timeout"
            )
            ts.exception_blame = ts
            recs[ts.key] = "erred"
        if not recs:
            return {}, {}
        return self.transitions(recs, stimulus_id)

    # ------------------------------------------------------ replica model

    def add_replica(self, ts: TaskState, ws: WorkerState) -> None:
        """Record that ws holds a replica of ts (reference scheduler.py:4760)."""
        if ws in ts.who_has:
            return
        ws.nbytes += ts.get_nbytes()
        ws.has_what[ts] = None
        ts.who_has.add(ws)
        if len(ts.who_has) == 2:
            self.replicated_tasks.add(ts)
        if self.mirror is not None:
            self.mirror.mark(ws)
        if self.native is not None:
            self.native.on_replica(ts, ws, True)
        if self.durability is not None:
            self.durability.mark_replica(ts, ws)

    def remove_replica(self, ts: TaskState, ws: WorkerState) -> None:
        ws.nbytes -= ts.get_nbytes()
        del ws.has_what[ts]
        ts.who_has.discard(ws)
        if len(ts.who_has) == 1:
            self.replicated_tasks.discard(ts)
        if self.mirror is not None:
            self.mirror.mark(ws)
        if self.native is not None:
            self.native.on_replica(ts, ws, False)
        if self.durability is not None:
            self.durability.mark_replica(ts, ws)

    def remove_all_replicas(self, ts: TaskState) -> None:
        nbytes = ts.get_nbytes()
        mirror = self.mirror
        if self.native is not None:
            self.native.mark_task(ts)
        for ws in ts.who_has:
            ws.nbytes -= nbytes
            del ws.has_what[ts]
            if mirror is not None:
                mirror.mark(ws)
            if self.native is not None:
                self.native.mark_worker(ws)
        if len(ts.who_has) > 1:
            self.replicated_tasks.discard(ts)
        if self.durability is not None:
            self.durability.mark_task(ts)
            for ws in ts.who_has:
                self.durability.mark_worker(ws)
        ts.who_has.clear()

    def update_nbytes(self, ts: TaskState, nbytes: int) -> None:
        old = ts.get_nbytes() if ts.nbytes >= 0 else 0
        diff = nbytes - old
        if ts.group is not None:
            ts.group.nbytes_total += diff
        if ts.prefix is not None:
            ts.prefix.nbytes_total += diff
        mirror = self.mirror
        native = self.native
        if native is not None:
            # incremental: the SoA applies the same holder-nbytes diffs
            native.on_nbytes(ts, nbytes)
        for ws in ts.who_has:
            ws.nbytes += diff
            if mirror is not None:
                mirror.mark(ws)
        ts.nbytes = nbytes
        if self.durability is not None:
            self.durability.mark_task(ts)

    # ------------------------------------------------------- events

    def log_event(self, topic: str | Iterable[str], msg: Any) -> None:
        """Ring-buffered structured events (reference scheduler.py:8244).

        Every call — internal state-machine events included — also reaches
        live topic subscribers via ``events_subscriber_hook`` (set by the
        Scheduler server)."""
        if isinstance(topic, str):
            topic = [topic]
        topic = list(topic)
        stamp = self.clock()
        for t in topic:
            self.events[t].append((stamp, msg))
            self.event_counts[t] += 1
        if self.events_subscriber_hook is not None:
            try:
                self.events_subscriber_hook(topic, msg)
            except Exception:
                logger.exception("event subscriber hook failed")

    # ----------------------------------------------------- stimuli (pure)

    def stimulus_task_finished(
        self, key: Key, worker: str, stimulus_id: str, **kwargs: Any
    ) -> tuple[dict, dict]:
        """A worker reported a finished task (reference scheduler.py:5025)."""
        if self.trace.journal_enabled:
            self.trace.record(
                "task-finished",
                {"key": key, "worker": worker, "kwargs": dict(kwargs)},
                stimulus_id,
            )
        ts = self.tasks.get(key)
        if ts is None or ts.state in ("released", "forgotten", "erred"):
            # stale completion for a cancelled task: tell worker to drop it
            wmsg = {
                "op": "free-keys",
                "keys": [key],
                "stimulus_id": stimulus_id,
            }
            return {}, {worker: [wmsg]}
        if ts.state == "memory":
            ws = self.workers.get(worker)
            if ws is not None and ws not in ts.who_has:
                self.add_replica(ts, ws)
            return {}, {}
        if ts.state != "processing":
            return {}, {}
        ts.metadata = kwargs.pop("metadata", None) or ts.metadata
        recs, cmsgs, wmsgs = self._transition(
            key, "memory", stimulus_id, worker=worker, **kwargs
        )
        client_msgs: dict = dict(cmsgs)
        worker_msgs: dict = dict(wmsgs)
        self._transitions(recs, client_msgs, worker_msgs, stimulus_id)
        recs2 = self.stimulus_queue_slots_maybe_opened(stimulus_id)
        self._transitions(recs2, client_msgs, worker_msgs, stimulus_id)
        return client_msgs, worker_msgs

    def stimulus_task_erred(
        self,
        key: Key,
        worker: str,
        stimulus_id: str,
        *,
        exception: Any = None,
        traceback: Any = None,
        exception_text: str = "",
        traceback_text: str = "",
        **kwargs: Any,
    ) -> tuple[dict, dict]:
        """A worker reported a task failure (reference scheduler.py:5106)."""
        if self.trace.journal_enabled:
            self.trace.record(
                "task-erred",
                {
                    "key": key,
                    "worker": worker,
                    "kwargs": {
                        "exception": exception,
                        "traceback": traceback,
                        "exception_text": exception_text,
                        "traceback_text": traceback_text,
                        **kwargs,
                    },
                },
                stimulus_id,
            )
        ts = self.tasks.get(key)
        if ts is None or ts.state != "processing":
            return {}, {}
        if ts.processing_on is None or ts.processing_on.address != worker:
            return {}, {}
        recs = {}
        client_msgs: dict = {}
        worker_msgs: dict = {}
        r, c, w = self._transition(
            key,
            "erred",
            stimulus_id,
            cause=key,
            exception=exception,
            traceback=traceback,
            exception_text=exception_text,
            traceback_text=traceback_text,
            worker=worker,
            **kwargs,
        )
        _merge_msgs_inplace(client_msgs, c)
        _merge_msgs_inplace(worker_msgs, w)
        self._transitions(r, client_msgs, worker_msgs, stimulus_id)
        recs2 = self.stimulus_queue_slots_maybe_opened(stimulus_id)
        self._transitions(recs2, client_msgs, worker_msgs, stimulus_id)
        return client_msgs, worker_msgs

    # ------------------------------------------- batched stimulus engine
    #
    # A batched-stream payload frequently carries a same-op FLOOD: a
    # worker reporting dozens of finished tasks, an AMM round releasing
    # replicas everywhere, a client graph submission.  The per-stimulus
    # entries above process one message per call — handler dispatch,
    # fresh message dicts, a queue-slots pass and a send_all flush per
    # message.  The ``*_batch`` entries fold a whole flood into one
    # engine pass: every event still drains through the SAME per-key
    # ``_transition`` handlers in the same order with its own
    # stimulus_id (so task states, ``transition_log``/``story`` entries
    # and message multisets are bit-identical to N sequential calls —
    # the per-key path remains the oracle, and
    # tests/test_batched_engine.py replays random traces through both),
    # but recommendations drain into ONE shared (client_msgs,
    # worker_msgs) pair, the ready frontier of each drain is placed
    # against the live occupancy without per-message re-entry, and the
    # queue-slots pass runs only when the queue is non-empty (when it is
    # empty the per-key pass is a no-op, so skipping it is exact).  The
    # caller flushes the merged messages once per payload; the server
    # additionally coalesces per-destination runs (compute-task batches,
    # merged free-keys) on the wire.

    def transitions_batch(
        self,
        batches: Iterable[tuple[dict[Key, str], str]],
    ) -> tuple[dict, dict]:
        """Drain several recommendation rounds into one shared message
        pair.  Each ``(recommendations, stimulus_id)`` round is processed
        to its fixed point before the next starts — identical semantics
        to calling :meth:`transitions` per round, without the per-round
        dict churn and per-round send."""
        client_msgs: dict = {}
        worker_msgs: dict = {}
        tr = self.trace
        for recommendations, stimulus_id in batches:
            if tr.journal_enabled:
                tr.record(
                    "transitions", {"recs": dict(recommendations)},
                    stimulus_id,
                )
            t0 = self.clock()
            # fault isolation matches the per-message path (one logged
            # failure per message, the rest of the payload proceeds):
            # a poison round must not discard the messages of rounds
            # already applied to state
            self.wall.push("engine.drain", stimulus_id)
            try:
                self._drain_round(
                    recommendations, client_msgs, worker_msgs, stimulus_id
                )
            except Exception:
                logger.exception(
                    "batched transition round failed (stimulus %s)",
                    stimulus_id,
                )
            finally:
                self.wall.pop()
            n = len(recommendations)
            self.hist_engine_batch.observe(n)
            self.hist_engine_pass.observe(self.clock() - t0)
            tr.emit("engine", "transitions", stimulus_id, n=n)
        return client_msgs, worker_msgs

    def stimulus_tasks_finished_batch(
        self,
        finishes: Iterable[tuple[Key, str, str, dict]],
    ) -> tuple[dict, dict]:
        """Batched :meth:`stimulus_task_finished`: one engine pass over a
        flood of ``(key, worker, stimulus_id, kwargs)`` completions.

        Events are processed in arrival order; each event's ready
        frontier drains to a fixed point (placing newly-ready dependents
        against the occupancy the sequential engine would see) before
        the next event is applied, so the result is bit-identical to N
        per-key calls — including per-key ``story`` entries, which keep
        their own per-event stimulus_id for causal tracing.
        """
        if not isinstance(finishes, (list, tuple)):
            finishes = list(finishes)
        ne = self.native
        if ne is not None and ne.active():
            # the native drain owns the whole flood: same journal
            # records, wall phases, histogram/trace observations, and
            # bit-identical outputs (per-key oracle escapes included).
            # None = flood below the amortization floor (min-flood):
            # fall through to the oracle below.
            out = ne.drive_finished_flood(finishes)
            if out is not None:
                return out
        client_msgs = {}
        worker_msgs = {}
        tr = self.trace
        t0 = self.clock()
        if tr.journal_enabled and finishes:
            # ONE record per flood, not per event: the flood is the
            # stimulus unit the engine consumes, and per-event records
            # cost more than the engine's own per-event work on the
            # steady-state path durability capture must stay under
            # (kwargs copied now — the loop below pops "metadata")
            tr.record(
                "tasks-finished-batch",
                {"finishes": [
                    [key, worker, sid, dict(kwargs)]
                    for key, worker, sid, kwargs in finishes
                ]},
                finishes[0][2],
            )
        self.wall.push("engine.drain", finishes[0][2] if finishes else "")
        try:
            for key, worker, stimulus_id, kwargs in finishes:
                # per-event fault isolation, same as the per-message path
                # (handle_stream logs one failure and proceeds): a poison
                # event must not discard the flood's already-accumulated
                # messages — transitions behind them are already applied
                try:
                    ts = self.tasks.get(key)
                    if ts is None or ts.state in ("released", "forgotten", "erred"):
                        # stale completion for a cancelled task: tell worker
                        # to drop it (merged per destination at flush time)
                        worker_msgs.setdefault(worker, []).append(
                            {
                                "op": "free-keys",
                                "keys": [key],
                                "stimulus_id": stimulus_id,
                            }
                        )
                        continue
                    if ts.state == "memory":
                        ws = self.workers.get(worker)
                        if ws is not None and ws not in ts.who_has:
                            self.add_replica(ts, ws)
                        continue
                    if ts.state != "processing":
                        continue
                    ts.metadata = kwargs.pop("metadata", None) or ts.metadata
                    recs, cmsgs, wmsgs = self._transition(
                        key, "memory", stimulus_id, worker=worker, **kwargs
                    )
                    _merge_msgs_inplace(client_msgs, cmsgs)
                    _merge_msgs_inplace(worker_msgs, wmsgs)
                    self._transitions(recs, client_msgs, worker_msgs, stimulus_id)
                    if self.queued:
                        # the per-key engine runs this pass per event; it is
                        # a no-op on an empty queue, so gating on ``queued``
                        # folds the common case without changing any outcome
                        recs2 = self.stimulus_queue_slots_maybe_opened(stimulus_id)
                        self._transitions(
                            recs2, client_msgs, worker_msgs, stimulus_id
                        )
                except Exception:
                    logger.exception(
                        "batched task-finished event failed (%s from %s, "
                        "stimulus %s)", key, worker, stimulus_id,
                    )
        finally:
            self.wall.pop()
        if finishes:
            self.hist_engine_batch.observe(len(finishes))
            self.hist_engine_pass.observe(self.clock() - t0)
            tr.emit(
                "engine", "task-finished-batch", finishes[0][2],
                n=len(finishes),
            )
        return client_msgs, worker_msgs

    def stimulus_tasks_erred_batch(
        self,
        errors: Iterable[tuple[Key, str, str, dict]],
    ) -> tuple[dict, dict]:
        """Batched :meth:`stimulus_task_erred` over ``(key, worker,
        stimulus_id, kwargs)`` failure reports; same bit-parity contract
        as :meth:`stimulus_tasks_finished_batch`."""
        client_msgs: dict = {}
        worker_msgs: dict = {}
        if not isinstance(errors, (list, tuple)):
            errors = list(errors)
        tr = self.trace
        t0 = self.clock()
        self.wall.push("engine.drain", errors[0][2] if errors else "")
        try:
            for key, worker, stimulus_id, kwargs in errors:
                if tr.journal_enabled:
                    tr.record(
                        "task-erred",
                        {"key": key, "worker": worker, "kwargs": dict(kwargs)},
                        stimulus_id,
                    )
                try:
                    ts = self.tasks.get(key)
                    if ts is None or ts.state != "processing":
                        continue
                    if ts.processing_on is None or ts.processing_on.address != worker:
                        continue
                    recs, cmsgs, wmsgs = self._transition(
                        key,
                        "erred",
                        stimulus_id,
                        cause=key,
                        worker=worker,
                        **kwargs,
                    )
                    _merge_msgs_inplace(client_msgs, cmsgs)
                    _merge_msgs_inplace(worker_msgs, wmsgs)
                    self._transitions(recs, client_msgs, worker_msgs, stimulus_id)
                    if self.queued:
                        recs2 = self.stimulus_queue_slots_maybe_opened(stimulus_id)
                        self._transitions(
                            recs2, client_msgs, worker_msgs, stimulus_id
                        )
                except Exception:
                    logger.exception(
                        "batched task-erred event failed (%s from %s, "
                        "stimulus %s)", key, worker, stimulus_id,
                    )
        finally:
            self.wall.pop()
        if errors:
            self.hist_engine_batch.observe(len(errors))
            self.hist_engine_pass.observe(self.clock() - t0)
            tr.emit(
                "engine", "task-erred-batch", errors[0][2], n=len(errors)
            )
        return client_msgs, worker_msgs

    def stimulus_release_worker_data(
        self, key: Key, worker: str, stimulus_id: str
    ) -> dict[Key, str]:
        """A worker no longer holds a replica (pure part of the
        ``release-worker-data`` handlers): drop the replica record and
        recommend ``released`` when it was the last one.

        Journaled as its own op: the replica removal is a state mutation
        OUTSIDE the transition engine, so a capture that only recorded
        the engine rounds would replay it un-removed and diverge.  The
        returned recommendations are fed through ``transitions`` /
        ``transitions_batch`` by the caller, which journals that round
        separately — replay applies this op's removal only and lets the
        following ``transitions`` record drive the engine."""
        if self.trace.journal_enabled:
            self.trace.record(
                "release-worker-data",
                {"key": key, "worker": worker},
                stimulus_id,
            )
        # an AMM drop decision for this (key, worker) realizes here
        # (join_amm is a dict-emptiness check when no AMM rows pend)
        self.ledger.join_amm(key, worker, "dropped")
        ts = self.tasks.get(key)
        ws = self.workers.get(worker)
        if ts is None or ws is None:
            return {}
        if ws in ts.who_has:
            self.remove_replica(ts, ws)
        if not ts.who_has:
            return {key: "released"}
        return {}

    def stimulus_retry(self, keys: Iterable[Key], stimulus_id: str) -> tuple[dict, dict]:
        """Re-run erred tasks (reference scheduler.py:5131)."""
        roots: OrderedSet[Key] = OrderedSet()
        for key in keys:
            ts = self.tasks.get(key)
            if ts is None:
                continue
            # walk up the blame chain to the root cause
            seen: set[Key] = set()
            while ts.exception_blame is not None and ts.exception_blame is not ts:
                if ts.key in seen:
                    break
                seen.add(ts.key)
                ts = ts.exception_blame
            if ts.state == "erred":
                roots.add(ts.key)
        # "waiting" routes erred -> released -> waiting (reference :5131)
        return self.transitions({k: "waiting" for k in roots}, stimulus_id)

    # ------------------------------------- worker stream stimuli (pure)
    #
    # Pure bodies of the scheduler server's scalar worker-op handlers
    # (add-keys / long-running / reschedule / missing-data /
    # request-refresh-who-has).  The networked Scheduler wraps each in a
    # thin trace-ingress + send_all shell; the sans-io cluster simulator
    # (distributed_tpu_torch/sim) calls them directly, so both planes run ONE
    # implementation instead of drifting copies.

    def stimulus_add_keys(
        self, keys: Iterable[Key], worker: str, stimulus_id: str
    ) -> tuple[dict, dict]:
        """Worker acquired replicas out-of-band (reference scheduler.py:5855).

        Journaled: replica registration mutates ``who_has`` OUTSIDE the
        transition engine, and placement decisions read it — a journal
        without add-keys replays a dependency graph with drifting
        placements (found by the simulator's record/replay parity
        test; the dep-free bench flood never exercised it)."""
        keys = list(keys)
        if self.trace.journal_enabled:
            self.trace.record(
                "add-keys", {"keys": keys, "worker": worker}, stimulus_id
            )
        ws = self.workers.get(worker)
        if ws is None:
            return {}, {}
        redundant = []
        for key in keys:
            ts = self.tasks.get(key)
            if ts is not None and ts.state == "memory":
                self.add_replica(ts, ws)
                # an AMM replicate decision for this (key, worker)
                # realizes here: acquire -> gather -> add-keys
                self.ledger.join_amm(
                    key, worker, "replicated", telemetry=self.telemetry,
                )
            else:
                redundant.append(key)
        if redundant:
            return {}, {worker: [{
                "op": "remove-replicas", "keys": redundant,
                "stimulus_id": stimulus_id,
            }]}
        return {}, {}

    def stimulus_scatter_data(
        self, key: Key, holders: list[str], nbytes: int,
        client: str | None, stimulus_id: str,
    ) -> tuple[dict, dict]:
        """Pure data landed on workers out-of-band (the pure per-key part
        of ``Scheduler.scatter``; the sim's scatter drives it directly).

        Journaled: scattered data enters ``memory`` through the engine
        but from no worker stimulus, so a journal tail without these
        records replays a cluster whose root partitions never existed."""
        holders = [a for a in holders if a in self.workers]
        if not holders:
            return {}, {}
        if self.trace.journal_enabled:
            self.trace.record(
                "scatter-data",
                {"key": key, "workers": list(holders), "nbytes": int(nbytes),
                 "client": client},
                stimulus_id,
            )
        ts = self.tasks.get(key)
        if ts is None:
            ts = self.new_task(key, None, "released")
        if client is not None:
            # register the client's interest BEFORE entering memory via
            # the engine, or the no-waiters/no-wants GC releases the key
            self.client_desires_keys([key], client)
        if ts.state not in ("released", "memory"):
            # key collides with a task mid-flight: leave the scheduler
            # state machine alone (the worker copy is surplus data)
            logger.warning(
                "scatter ignoring key %r already in state %r", key, ts.state
            )
            return {}, {}
        if ts.priority is None:
            ts.priority = (0, 0, 0)
        client_msgs: dict = {}
        worker_msgs: dict = {}
        if ts.state == "released":
            # through the engine so accounting stays consistent and
            # waiting dependents are recommended onward
            recs, cmsgs, wmsgs = self._transition(
                key, "memory", stimulus_id,
                worker=holders[0], nbytes=int(nbytes),
            )
            _merge_msgs_inplace(client_msgs, cmsgs)
            _merge_msgs_inplace(worker_msgs, wmsgs)
            self._transitions(recs, client_msgs, worker_msgs, stimulus_id)
            extra = holders[1:]
        else:
            self.update_nbytes(ts, int(nbytes))
            extra = holders
        for addr in extra:
            ws = self.workers.get(addr)
            if ws is not None:
                self.add_replica(ts, ws)
        return client_msgs, worker_msgs

    def stimulus_long_running(
        self, key: Key, worker: str, compute_duration: float,
        stimulus_id: str,
    ) -> tuple[dict, dict]:
        """Task seceded from its thread slot (reference scheduler.py:5906)."""
        if self.trace.journal_enabled:
            self.trace.record(
                "long-running",
                {"key": key, "worker": worker,
                 "compute_duration": compute_duration},
                stimulus_id,
            )
        ts = self.tasks.get(key)
        if ts is None or ts.processing_on is None:
            return {}, {}
        ws = ts.processing_on
        if ws.address != worker:
            return {}, {}
        occ = ws.processing.get(ts)
        if occ is not None:
            self._adjust_occupancy(ws, -occ)
            # graft-lint: allow[mirror-parity] row marked by the _adjust_occupancy above and the check_idle_saturated below
            ws.processing[ts] = 0.0
        ws.long_running.add(ts)
        if self.native is not None:
            self.native.mark_task(ts)
        if self.durability is not None:
            self.durability.mark_replica(ts, ws)
        self.check_idle_saturated(ws)
        return {}, {}

    def stimulus_steal_move(
        self, key: Key, victim: str, thief: str, stimulus_id: str,
        kind: str = "steal",
    ) -> tuple[dict, dict]:
        """Re-place a processing task from ``victim`` onto ``thief`` —
        the resolved outcome of a steal confirm (or a speculative move).

        Extracted from ``WorkStealing.move_task_confirm`` so the move is
        journaled as its own replayable op: the confirm path mutates
        ``processing_on`` OUTSIDE the transition engine, and a journal
        tail spanning a confirmed steal would otherwise reconstruct the
        task on the wrong worker (the restart-during-in-flight-steal
        case).  Guards mirror the confirm path; a guard miss is a no-op
        both live and on replay."""
        ts = self.tasks.get(key)
        if ts is None or ts.state != "processing":
            return {}, {}
        victim_ws = self.workers.get(victim)
        thief_ws = self.workers.get(thief)
        if victim_ws is None or ts.processing_on is not victim_ws:
            return {}, {}
        if self.trace.journal_enabled:
            self.trace.record(
                "steal-move",
                {"key": key, "victim": victim, "thief": thief, "kind": kind},
                stimulus_id,
            )
        if thief_ws is None or thief_ws not in self.running:
            # thief died meanwhile: reschedule from scratch
            return self._transitions_observed({key: "released"}, stimulus_id)
        self._exit_processing_common(ts)
        ts.state = "waiting"  # transient; re-enter processing on thief
        victim_ws.long_running.discard(ts)
        worker_msgs = self._add_to_processing(
            ts, thief_ws, stimulus_id, kind=kind
        )
        return {}, worker_msgs

    def stimulus_reschedule(
        self, key: Key, worker: str, stimulus_id: str
    ) -> tuple[dict, dict]:
        """Worker bounced the task back for re-placement (Reschedule)."""
        if self.trace.journal_enabled:
            self.trace.record(
                "reschedule", {"key": key, "worker": worker}, stimulus_id
            )
        ts = self.tasks.get(key)
        if ts is None or ts.processing_on is None:
            return {}, {}
        if ts.processing_on.address != worker:
            return {}, {}
        # _transitions_observed, NOT transitions: this stimulus already
        # journaled itself, and replay re-derives the round from it — a
        # nested "transitions" record would run the round twice
        return self._transitions_observed({key: "released"}, stimulus_id)

    def stimulus_missing_data(
        self, key: Key, errant_worker: str, stimulus_id: str
    ) -> tuple[dict, dict]:
        """A peer did not have data it was supposed to (reference :5869)."""
        if self.trace.journal_enabled:
            self.trace.record(
                "missing-data",
                {"key": key, "errant_worker": errant_worker}, stimulus_id,
            )
        ts = self.tasks.get(key)
        ws = self.workers.get(errant_worker)
        if ts is None:
            return {}, {}
        worker_msgs: dict = {}
        if ws is not None and ws in ts.who_has:
            self.remove_replica(ts, ws)
            # the replica model is authoritative: once this copy is
            # written off, tell the errant worker to drop it too.  If
            # the report was right this is a no-op; if the serve merely
            # FAILED (a partition) the holder would otherwise keep a
            # replica the scheduler no longer tracks — free-keys at
            # forget only reaches who_has members, so the orphan
            # outlives the task forever (census-found: partition chaos
            # left scheduler-untracked memory keys on healed workers)
            worker_msgs[errant_worker] = [{
                "op": "remove-replicas", "keys": [key],
                "stimulus_id": stimulus_id,
            }]
        if not ts.who_has:
            # see stimulus_reschedule: self-journaled, so the round must
            # not journal again
            cm, wm = self._transitions_observed({key: "released"}, stimulus_id)
            return cm, _merge_msgs(worker_msgs, wm)
        return {}, worker_msgs

    def stimulus_request_refresh_who_has(
        self, keys: Iterable[Key], worker: str, stimulus_id: str
    ) -> tuple[dict, dict]:
        """A worker wants fresh replica locations for its missing tasks."""
        who_has = {}
        for key in keys:
            ts = self.tasks.get(key)
            who_has[key] = (
                [ws.address for ws in ts.who_has] if ts is not None else []
            )
        return {}, {worker: [{
            "op": "refresh-who-has", "who_has": who_has,
            "stimulus_id": stimulus_id,
        }]}

    # ------------------------------------------------ worker lifecycle

    def add_worker_state(
        self,
        address: str,
        *,
        nthreads: int = 1,
        memory_limit: int = 0,
        name: object = None,
        resources: dict[str, float] | None = None,
        server_id: str | None = None,
    ) -> WorkerState:
        """Register a worker (pure part of reference add_worker :4308)."""
        if address in self.workers:
            return self.workers[address]
        if self.trace.journal_enabled:
            # worker registration is structural state the engine stimuli
            # assume: a journal tail spanning an autoscale join must
            # replay it or every later placement references a ghost
            self.trace.record(
                "add-worker",
                {"address": address, "nthreads": int(nthreads),
                 "memory_limit": int(memory_limit),
                 "name": name if isinstance(name, (str, int, float, type(None))) else str(name),
                 "resources": dict(resources or {}),
                 "server_id": server_id},
                f"add-worker-{address}",
            )
        ws = WorkerState(
            address, nthreads=nthreads, memory_limit=memory_limit, name=name,
            server_id=server_id,
        )
        # keep the engine's clock domain: WorkerState's constructor
        # stamps the module clock, but inside this engine every
        # timestamp reads the injected clock (virtual in the simulator;
        # the live server overwrites last_seen on each heartbeat)
        ws.last_seen = self.clock()
        if resources:
            ws.resources.update(resources)
            ws.used_resources = dict.fromkeys(resources, 0)
            for r, q in resources.items():
                self.resources[r][address] = q
        self.workers[address] = ws
        self.aliases[ws.name] = address
        self.running.add(ws)
        self.total_nthreads += nthreads
        self.total_nthreads_history.append((self.clock(), self.total_nthreads))
        if self.mirror is not None:
            self.mirror.on_add_worker(ws)
        if self.native is not None:
            self.native.on_add_worker(ws)
        if self.durability is not None:
            self.durability.mark_worker(ws)
        self.check_idle_saturated(ws)
        if self.placement is not None:
            self.placement.on_add_worker(self, ws)
        return ws

    def set_worker_status(
        self, ws: WorkerState, status: str, status_seq: int | None = None
    ) -> None:
        """Mirror-aware status mutation (running/idle membership updates
        stay at the callers — server.handle_worker_status_change owns
        the transition side effects)."""
        ws.status = status
        if status_seq is not None:
            ws.status_seq = status_seq
        if self.mirror is not None:
            self.mirror.mark(ws)
        if self.native is not None:
            self.native.mark_worker(ws)
        if self.durability is not None:
            self.durability.mark_worker(ws)

    def set_worker_nthreads(self, ws: WorkerState, nthreads: int) -> None:
        """Mirror-aware worker resize.  No production message resizes a
        live worker yet (reconnect is remove+add); this is the designated
        funnel for when one does, and the churn property tests drive it
        so the mirror's resize delta path stays proven."""
        self.total_nthreads += nthreads - ws.nthreads
        ws.nthreads = nthreads
        if self.native is not None:
            self.native.mark_worker(ws)
        if self.durability is not None:
            self.durability.mark_worker(ws)
        self.total_nthreads_history.append((self.clock(), self.total_nthreads))
        self.check_idle_saturated(ws)

    def stimulus_worker_status_change(
        self, worker: str, status: str, status_seq: int,
        stimulus_id: str,
    ) -> tuple[dict, dict]:
        """Pure body of the server's worker-status-change handler: the
        running/idle membership flips, homed-task release and parked
        splicing happen OUTSIDE the engine, so the op journals itself
        and the engine rounds it triggers replay from this record."""
        ws = self.workers.get(worker)
        if ws is None:
            return {}, {}
        if status_seq >= 0 and status_seq < ws.status_seq:
            # stale stream message ordered behind a fresher flip
            # (possible after a heartbeat-applied reconciliation)
            return {}, {}
        if self.trace.journal_enabled:
            self.trace.record(
                "worker-status-change",
                {"worker": worker, "status": status,
                 "status_seq": int(status_seq)},
                stimulus_id,
            )
        self.set_worker_status(
            ws, status, status_seq if status_seq >= 0 else None
        )
        ws.status_changed_at = self.clock()
        if status == WORKER_STATUS_PAUSED:
            self.running.discard(ws)
            self.idle.pop(ws.address, None)
            self.idle_task_count.discard(ws)
            # home-stacked tasks on a paused worker become stealable
            # again — nothing else would move them off a stalled home
            steal = self.extensions.get("stealing")
            for ts in ws.processing:
                if ts.homed:
                    ts.homed = False
                    if steal is not None:
                        steal.put_key_in_stealable(ts)
            # a paused home can't pull: return its parked tasks to the
            # global pop heap and let open slots elsewhere take them
            if ws.address in self.parked:
                self.splice_parked(ws.address)
                recs = self.stimulus_queue_slots_maybe_opened(stimulus_id)
                return self._transitions_observed(recs, stimulus_id)
        elif status == WORKER_STATUS_RUNNING:
            self.running.add(ws)
            self.check_idle_saturated(ws)
            recs = self.bulk_schedule_unrunnable_after_adding_worker(ws)
            recs.update(self.stimulus_queue_slots_maybe_opened(stimulus_id))
            return self._transitions_observed(recs, stimulus_id)
        return {}, {}

    def bulk_schedule_unrunnable_after_adding_worker(self, ws: WorkerState) -> dict[Key, str]:
        """Try no-worker tasks on the new worker (reference scheduler.py:3173)."""
        runnable = [
            ts
            for ts in self.unrunnable
            if (valid := self.valid_workers(ts)) is None or ws in valid
        ]
        runnable.sort(key=lambda ts: (ts.priority, ts.key), reverse=True)
        return {ts.key: "processing" for ts in runnable}

    def remove_worker_state(
        self,
        address: str,
        *,
        stimulus_id: str,
        safe: bool = False,
        expected: bool = False,
    ) -> tuple[dict, dict]:
        """Unregister a worker, rescheduling its work and releasing its
        replicas (pure part of reference remove_worker :5180).

        Returns (client_msgs, worker_msgs) after draining all resulting
        transitions.  Lineage recomputation happens here: tasks whose only
        replica lived on the dead worker are recommended back through
        released -> waiting and will be recomputed from run_spec.
        """
        ws = self.workers.get(address)
        if ws is None:
            return {}, {}
        if self.trace.journal_enabled:
            # worker removal rewrites replica truth and reschedules its
            # processing set — a chaos capture replays it as its own op
            self.trace.record(
                "remove-worker", {"worker": address, "safe": bool(safe)},
                stimulus_id,
            )
        del self.workers[address]
        self.aliases.pop(ws.name, None)
        self.telemetry.forget_worker(address)
        # finalize open ledger rows pointing at the departed worker (the
        # telemetry link-leak lesson): their joins can never come, and the
        # released cascade below must not mis-join them as cancellations
        self.ledger.resolve_worker(address, now=self.clock())
        ws.status = WORKER_STATUS_CLOSED
        self.running.discard(ws)
        self.idle.pop(ws.address, None)
        self.idle_task_count.discard(ws)
        self.saturated.discard(ws)
        self.total_nthreads -= ws.nthreads
        self.total_nthreads_history.append((self.clock(), self.total_nthreads))
        self._total_occupancy -= ws.occupancy
        ws.occupancy = 0.0
        for r in ws.resources:
            self.resources[r].pop(address, None)
        if self.mirror is not None:
            self.mirror.on_remove_worker(ws)
        if self.native is not None:
            self.native.on_remove_worker(ws)
        if self.durability is not None:
            self.durability.on_remove_worker(ws)
        if self.placement is not None:
            self.placement.on_remove_worker(self, ws)
        # tasks parked for the dead worker become globally poppable again
        self.splice_parked(address)
        # drop group co-assignment cursors pointing at the dead worker:
        # decide_worker re-validates membership before using one, so
        # this is behavior-neutral — but the stale reference pinned the
        # whole removed WorkerState object per group (census-found;
        # removals are rare, O(groups) is fine here)
        for tg in self.task_groups.values():
            if tg.last_worker is ws:
                tg.last_worker = None
                tg.last_worker_tasks_left = 0

        recommendations: dict[Key, str] = {}
        client_msgs: dict = {}
        worker_msgs: dict = {}

        for ts in list(ws.processing):
            k = ts.key
            recommendations[k] = "released"
            if not safe:
                ts.suspicious += 1
                ts.erred_on.add(address)
                if ts.suspicious > self.ALLOWED_FAILURES:
                    del recommendations[k]
                    e = KilledWorker(
                        task=k, last_worker=address, allowed_failures=self.ALLOWED_FAILURES
                    )
                    r, c, w = self._transition(
                        k,
                        "erred",
                        stimulus_id,
                        exception=e,
                        cause=k,
                        exception_text=str(e),
                        worker=address,
                    )
                    recommendations.update(r)
                    _merge_msgs_inplace(client_msgs, c)
                    _merge_msgs_inplace(worker_msgs, w)
                    self.log_event(
                        "all",
                        {"action": "killed-worker", "key": k, "worker": address},
                    )

        for ts in list(ws.has_what):
            self.remove_replica(ts, ws)
            if not ts.who_has:
                if ts.run_spec:
                    recommendations[ts.key] = "released"
                else:  # pure data, lost for good
                    recommendations[ts.key] = "forgotten"

        self._transitions(recommendations, client_msgs, worker_msgs, stimulus_id)
        # the departed worker must not receive queued messages
        worker_msgs.pop(address, None)
        recs2 = self.stimulus_queue_slots_maybe_opened(stimulus_id)
        self._transitions(recs2, client_msgs, worker_msgs, stimulus_id)
        return client_msgs, worker_msgs

    # ------------------------------------------------ client lifecycle

    def add_client_state(self, client: str) -> ClientState:
        cs = self.clients.get(client)
        if cs is None:
            cs = self.clients[client] = ClientState(client, self.clock())
        return cs

    def client_desires_keys(self, keys: Iterable[Key], client: str) -> None:
        keys = list(keys)
        if self.trace.journal_enabled:
            # client interest gates the release/forget GC: a tail
            # replayed without it forgets keys the client still holds
            self.trace.record(
                "client-desires-keys", {"keys": keys, "client": client},
                f"client-desires-{client}",
            )
        cs = self.add_client_state(client)
        for key in keys:
            ts = self.tasks.get(key)
            if ts is None:
                ts = self.new_task(key, None, "released")
            ts.who_wants.add(cs)
            cs.wants_what.add(ts)
            if self.native is not None:
                self.native.on_who_wants(ts)
            if self.durability is not None:
                self.durability.mark_task(ts)

    def client_releases_keys(
        self, keys: Iterable[Key], client: str, stimulus_id: str
    ) -> tuple[dict, dict]:
        """Client no longer wants these keys (reference scheduler.py:5441)."""
        cs = self.clients.get(client)
        if cs is None:
            return {}, {}
        keys = list(keys)
        if self.trace.journal_enabled:
            # journaled as its own op (the interest mutation happens
            # OUTSIDE the engine); the engine round below is re-derived
            # on replay, so it must NOT write a nested "transitions"
            # record — the reschedule/missing-data rule
            self.trace.record(
                "client-releases-keys", {"keys": keys, "client": client},
                stimulus_id,
            )
        recommendations: dict[Key, str] = {}
        for key in keys:
            ts = self.tasks.get(key)
            if ts is None or ts not in cs.wants_what:
                continue
            cs.wants_what.discard(ts)
            ts.who_wants.discard(cs)
            if self.native is not None:
                self.native.on_who_wants(ts)
            if self.durability is not None:
                self.durability.mark_task(ts)
            if not ts.who_wants:
                if not ts.dependents:
                    recommendations[key] = "forgotten"
                elif not ts.waiters:
                    recommendations[key] = "released"
        return self._transitions_observed(recommendations, stimulus_id)

    def remove_client_state(self, client: str, stimulus_id: str) -> tuple[dict, dict]:
        cs = self.clients.get(client)
        if cs is None:
            return {}, {}
        out = self.client_releases_keys(
            [ts.key for ts in cs.wants_what], client, stimulus_id
        )
        del self.clients[client]
        return out

    # ------------------------------------------------------ graph intake

    def update_graph_core(
        self,
        tasks: dict[Key, Any],
        dependencies: dict[Key, set[Key]],
        keys: Iterable[Key],
        *,
        client: str | None = None,
        priorities: dict[Key, tuple] | None = None,
        user_priority: int | dict[Key, int] = 0,
        generation: int = 0,
        annotations_by_key: dict[Key, dict] | None = None,
        retries: int | dict[Key, int] | None = None,
        actors: bool | list[Key] = False,
        stimulus_id: str = "update-graph",
    ) -> tuple[dict, dict]:
        """Materialize a graph into TaskStates and kick off transitions.

        Pure equivalent of the reference's update_graph -> _generate_taskstates
        -> _set_priorities -> transitions (scheduler.py:4662-4981).
        ``tasks`` maps key -> run_spec (TaskSpec or literal); ``priorities``
        are static ranks from graph.order (computed by the caller, possibly
        offloaded).
        """
        if priorities is None:
            from distributed_tpu_torch.graph.order import order as order_fn

            # deps on keys submitted in earlier graphs are already-known
            # tasks: exclude them from static ordering of this batch
            known = set(dependencies)
            pruned = {
                k: {d for d in deps if d in known}
                for k, deps in dependencies.items()
            }
            priorities = {k: (r,) for k, r in order_fn(pruned).items()}

        if self.trace.journal_enabled:
            # graph intake is journaled with RESOLVED priorities and
            # per-dependency lists in this call's exact iteration order,
            # so a tail replay materializes bit-identical TaskStates
            # (insertion order of the relation sets included) without
            # re-running graph.order.  run_specs are encoded to a
            # JSON-pure form (scheduler/durability.py) so the record's
            # digest survives a dump/load round trip and a restarted
            # scheduler can still dispatch the tasks.  The engine round
            # at the end of this method is re-derived on replay and
            # must not write a nested "transitions" record.
            from distributed_tpu_torch.scheduler.durability import encode_run_spec

            self.trace.record(
                "update-graph",
                {
                    "tasks": {k: encode_run_spec(v) for k, v in tasks.items()},
                    "dependencies": {
                        k: list(v) for k, v in dependencies.items()
                    },
                    "keys": list(keys),
                    "priorities": {
                        k: list(v) for k, v in priorities.items()
                    },
                    "client": client,
                    "user_priority": user_priority,
                    "generation": generation,
                    "annotations_by_key": annotations_by_key,
                    "retries": retries,
                    "actors": actors,
                },
                stimulus_id,
            )

        # reuse a trailing EMPTY computation: dependency-only or
        # already-known-key submissions must not flush real history out
        # of the bounded deque
        if self.computations and not self.computations[-1].groups:
            computation = self.computations[-1]
        else:
            computation = Computation(self.clock())
            self.computations.append(computation)
        touched: list[TaskState] = []
        created: list[TaskState] = []
        for key, spec in tasks.items():
            ts = self.tasks.get(key)
            fresh = False
            if ts is None:
                # run_spec lives as long as the task: compact opaque
                # specs so a ~100-byte Serialized slice doesn't pin the
                # whole pooled receive buffer it arrived in (docs/wire.md)
                ts = self.new_task(key, compact_frames(spec), "released")
                fresh = spec is not None
                created.append(ts)
            elif ts.run_spec is None and spec is not None:
                ts.run_spec = compact_frames(spec)
                fresh = True
            # only NEWLY runnable tasks attribute their group here: a
            # resubmission of known keys must not clone old groups into
            # a fresh Computation (it would both duplicate history and
            # flush the bounded deque)
            if fresh and ts.group is not None:
                computation.groups.add(ts.group)
            touched.append(ts)

        native = self.native
        for key, deps in dependencies.items():
            ts = self.tasks[key]
            for dkey in deps:
                dts = self.tasks.get(dkey)
                if dts is None:
                    dts = self.new_task(dkey, None, "released")
                ts.add_dependency(dts)
                if native is not None:
                    native.mark_task(dts)
            if native is not None:
                native.mark_task(ts)

        for ts in touched:
            key = ts.key
            if ts.priority is None and key in priorities:
                rank = priorities[key]
                upri = (
                    user_priority.get(key, 0)
                    if isinstance(user_priority, dict)
                    else user_priority
                )
                ts.priority = (-upri, generation) + tuple(rank)
            if isinstance(retries, dict):
                ts.retries = retries.get(key, 0)
            elif retries:
                ts.retries = retries
            if annotations_by_key and key in annotations_by_key:
                ts.annotations = dict(annotations_by_key[key])
                ann = ts.annotations
                if "workers" in ann:
                    w = ann["workers"]
                    ts.worker_restrictions = set([w] if isinstance(w, str) else w)
                if "allow_other_workers" in ann:
                    ts.loose_restrictions = bool(ann["allow_other_workers"])
                if "resources" in ann:
                    ts.resource_restrictions = dict(ann["resources"])
                if "retries" in ann:
                    ts.retries = ann["retries"]
                if "priority" in ann and ts.priority is not None:
                    new_pri = (-ann["priority"],) + ts.priority[1:]
                    if new_pri != ts.priority and ts in self.queued:
                        # HeapSet orders by add-time priority: re-add so
                        # the bump is visible to peekn/pop, not stale
                        self.queued.remove(ts)
                        in_global = ts in self.queued_unparked
                        if in_global:
                            self.queued_unparked.remove(ts)
                        pheap = self.parked.get(
                            self._parked_keys.get(ts.key, "")
                        )
                        if pheap is not None and ts in pheap:
                            pheap.remove(ts)
                        else:
                            pheap = None
                        ts.priority = new_pri
                        self.queued.add(ts)
                        if in_global:
                            self.queued_unparked.add(ts)
                        if pheap is not None:
                            pheap.add(ts)
                    else:
                        ts.priority = new_pri
            if (actors is True) or (isinstance(actors, list) and key in actors):
                ts.actor = True
            if native is not None:
                native.mark_task(ts)

        # fill priorities for tasks created only as dependencies
        for ts in self.tasks.values():
            if ts.priority is None:
                ts.priority = (0, generation, 0)

        if client is not None:
            self.client_desires_keys(keys, client)

        if self.placement is not None and hasattr(self.placement, "plan_graph"):
            # one device call plans the whole incoming graph; consumed as
            # per-task hints by decide_worker_non_rootish.  The graph's
            # stimulus id rides along so the kernel dispatch joins the
            # submission in the flight recorder.
            try:
                self.placement.plan_graph(
                    self, {ts.key: ts for ts in touched},
                    stimulus_id=stimulus_id,
                )
            except Exception:
                logger.exception("placement planning failed")

        recommendations: dict[Key, str] = {}
        # seed transitions from the leaves up: released tasks that are
        # wanted (directly or transitively) go to waiting
        wanted: set[TaskState] = set()
        stack = [self.tasks[k] for k in keys if k in self.tasks]
        while stack:
            ts = stack.pop()
            if ts in wanted:
                continue
            wanted.add(ts)
            stack.extend(ts.dependencies)
        # highest priority inserted last: _transitions pops LIFO, so the
        # best-priority task reaches decide_worker first
        for ts in sorted(wanted, key=lambda ts: ts.priority or (0,), reverse=True):
            if ts.state == "released" and ts.run_spec is not None:
                recommendations[ts.key] = "waiting"
        # _transitions_observed, NOT transitions: the update-graph
        # journal record above replays this round itself
        client_msgs, worker_msgs = self._transitions_observed(
            recommendations, stimulus_id
        )
        # cull unreachable junk at ingest: a task CREATED by this batch
        # that no requested key transitively needs, nothing depends on
        # and no client wants would otherwise sit released forever (the
        # reference relies on client-side culling; at millions-of-users
        # scale a buggy client must not grow the scheduler without
        # bound — found by the state census's quiesce gate).  A second
        # engine round, deliberately: released->forgotten is an
        # uncompiled edge, and folding it into the round above would
        # bounce the WHOLE wanted-set drain off the native engine.
        cull: dict[Key, str] = {}
        for ts in created:
            if (
                ts not in wanted
                and ts.state == "released"
                and not ts.dependents
                and not ts.who_wants
                and not ts.waiters
            ):
                cull[ts.key] = "forgotten"
        if cull:
            cm2, wm2 = self._transitions_observed(cull, stimulus_id)
            client_msgs = _merge_msgs(client_msgs, cm2)
            worker_msgs = _merge_msgs(worker_msgs, wm2)
        # immediately report already-completed keys
        for key in keys:
            ts = self.tasks.get(key)
            if ts is None:
                continue
            if ts.state == "memory":
                for cs in ts.who_wants:
                    client_msgs.setdefault(cs.client_key, []).append(
                        {"op": "key-in-memory", "key": key, "type": ts.type}
                    )
            elif ts.state == "erred":
                for cs in ts.who_wants:
                    client_msgs.setdefault(cs.client_key, []).append(
                        {
                            "op": "task-erred",
                            "key": key,
                            "exception": ts.exception,
                            "traceback": ts.traceback,
                        }
                    )
        return client_msgs, worker_msgs

    # -------------------------------------------------------- validation

    def validate_task_state(self, ts: TaskState) -> None:
        """Invariant check for one task (reference scheduler.py:8596)."""
        try:
            assert ts.state in ALL_TASK_STATES or ts.state == "forgotten", ts

            for dts in ts.waiting_on:
                # replica truth: a dep mid-recompute may be state "memory"
                # transiently, but a task only waits on deps with no
                # stored replica (reference validate_waiting:
                # bool(who_has) != (dts in waiting_on))
                assert not dts.who_has, (ts, dts)
                assert ts in dts.waiters, (ts, dts)
            for dts in ts.dependencies:
                assert ts in dts.dependents, (ts, dts)
                # the real data-safety invariant, checked from the
                # dependent side (reference validate_task_state "dep
                # missing"): an in-play task either still waits on the
                # dep or the dep has a live replica
                if ts.state in ("waiting", "queued", "processing", "no-worker"):
                    assert dts in ts.waiting_on or dts.who_has, (
                        "dep missing", ts, dts,
                    )
            for dts in ts.waiters:
                # waiters = dependents not yet finished (reference
                # scheduler.py:2110): they may be processing against a
                # dep that is memory now — or released mid-cascade, in
                # which case the release has already recommended them
                # back to waiting
                assert dts.state in ("waiting", "queued", "processing", "no-worker"), (
                    ts,
                    dts,
                    dts.state,
                )

            if ts.state == "waiting":
                assert not ts.who_has, ts
                assert not ts.processing_on, ts
            elif ts.state == "queued":
                assert ts in self.queued, ts
                assert not ts.processing_on, ts
                assert not ts.who_has, ts
            elif ts.state == "processing":
                assert ts.processing_on, ts
                assert ts in ts.processing_on.processing, ts
                assert not ts.waiting_on, ts
                assert not ts.who_has, ts
            elif ts.state == "memory":
                assert ts.who_has, ts
                assert not ts.processing_on, ts
                assert not ts.waiting_on, ts
                for ws in ts.who_has:
                    assert ts in ws.has_what, (ts, ws)
            elif ts.state == "no-worker":
                assert ts in self.unrunnable, ts
                assert not ts.processing_on, ts
                assert not ts.who_has, ts
            elif ts.state == "erred":
                assert not ts.processing_on, ts
                assert not ts.who_has, ts
            elif ts.state == "released":
                assert not ts.processing_on, ts
                assert not ts.who_has, ts
                assert not ts.waiting_on, ts
            assert (ts.processing_on is not None) == (ts.state == "processing"), ts
            assert bool(ts.who_has) == (ts.state == "memory"), ts
        except AssertionError as e:
            raise InvalidTaskState(
                f"invalid task state for {ts!r} ({ts.state}): {e}"
            ) from e

    def validate_worker_state(self, ws: WorkerState) -> None:
        for ts in ws.has_what:
            assert ws in ts.who_has, (ws, ts)
        for ts in ws.processing:
            assert ts.processing_on is ws, (ws, ts)
            assert ts.state == "processing", (ws, ts)

    def validate_state(self) -> None:
        """Full invariant check (reference scheduler.py:5544)."""
        for ts in self.tasks.values():
            self.validate_task_state(ts)
        for ws in self.workers.values():
            self.validate_worker_state(ws)
        for ts in self.queued:
            assert ts.state == "queued", ts
        # parked bookkeeping: queued is the disjoint union of the global
        # pop heap and the per-worker parked heaps
        n_parked = 0
        for addr, heap in self.parked.items():
            for ts in heap:
                if ts.state == "queued":
                    n_parked += 1
                    assert ts not in self.queued_unparked, ts
                    assert self._parked_keys.get(ts.key) == addr, ts
        for ts in self.queued_unparked:
            assert ts in self.queued, ts
        for ts in self.queued:
            assert ts in self.queued_unparked or ts.key in self._parked_keys, (
                "queued task reachable by no pop path", ts,
            )
        for ts in self.unrunnable:
            assert ts.state == "no-worker", ts


WORKER_STATUS_CLOSED = "closed"


def _worker_full(ws: WorkerState, saturation_factor: float) -> bool:
    """Is ws at/above its saturation threshold (reference scheduler.py:8750)."""
    if saturation_factor == float("inf"):
        return False
    return len(ws.processing) >= max(math_ceil(ws.nthreads * saturation_factor), 1)


def _merge_msgs(a: dict, b: dict) -> dict:
    out = {k: list(v) for k, v in a.items()}
    _merge_msgs_inplace(out, b)
    return out


def _merge_msgs_inplace(dst: dict, src: dict) -> None:
    for k, v in src.items():
        dst.setdefault(k, []).extend(v)


import math  # noqa: E402

math_isfinite = math.isfinite
math_ceil = math.ceil
