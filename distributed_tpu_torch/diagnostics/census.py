"""State census + retention sentinel (docs/observability.md "State
census & retention").

The observability stack answers "what happened" (flight recorder),
"what is true" (telemetry), "where the time went" (self-profiler) and
"was the decision right" (ledger) — this module answers **"what are we
still holding"**.  A ``StateCensus`` is a typed inventory of every
long-lived container a control plane owns: scheduler tasks by state,
relation-set edges, client interest, HeapSet queues, stealing level
sets and in-flight maps, mirror slots, native-engine SoA rows,
durability dirty sets, telemetry links, ledger ring occupancy, the
flight-recorder rings, and the worker-side twins.  Each registered
*family* carries a kind from a fixed vocabulary, a cheap probe, an
optional from-scratch verification walk, and — for families that are
legitimately non-empty at rest — an allowlist reason.

Three consumers:

- **quiesce-clean proofs**: when a control plane is quiescent (no
  tasks, nothing in flight), the census diffed against the empty
  baseline must be zero outside the allowlist; any residue is a named
  finding with a bounded ``gc.get_referrers`` sample identifying the
  holding container.  Every sim chaos scenario and ``sim.run_ab`` end
  on this gate (sim/validate.check_census_clean) — the bounded-memory
  oracle ROADMAP item 5(b)'s stimulus fuzzer asserts.
- **walk-vs-counter audits** (``DTPU_CENSUS_CHECK``, mirror-parity
  style): families whose probe reads a *maintained* counter (task
  state counts maintained by both transition engines, the ledger's
  derived open-row count, native SoA row registries, mirror slots)
  are recounted from scratch and any drift raises
  :class:`CensusParityError`.
- **live leak detection**: a :class:`RetentionSentinel` ticks on the
  server loop, folds per-family growth slopes into EWMAs, and emits
  flight-recorder ``leak`` events + ``dtpu_census_*`` gauges when a
  family grows without bound.

This file is pure (no IO, no event loop, no threads): the sans-io
state machines build their census in ``__init__`` and the monotonic
lint covers it.  ``gc`` introspection only runs on the slow finding
path, never per probe.
"""

from __future__ import annotations

import gc
import os
from collections import deque
from typing import Any, Callable, Iterable

from distributed_tpu_torch import config
from distributed_tpu_torch.ledger import _OUTCOME as _LEDGER_OUTCOME
from distributed_tpu_torch.ledger import _W as _LEDGER_W
from distributed_tpu_torch.utils import time

#: bump when the snapshot record shape changes (docs/observability.md)
CENSUS_SCHEMA_VERSION = 1

#: family vocabulary — the ``kind`` field (docs/observability.md):
#:   state     resident first-class records (tasks, workers, clients)
#:   edges     relation-set members summed across records
#:   queue     poppable work queues (HeapSet / deque members)
#:   in-flight open windows awaiting a completion that must come
#:   interest  who-wants / wants-what client interest edges
#:   index     derived lookup structures that must shadow a primary
#:   ring      bounded-by-construction rings/deques (always allowlisted)
#:   pool      reusable capacity (free lists, buffer pools, tombstones)
#:   scratch   between-pass marks drained by the next flush/snapshot
FAMILY_KINDS = (
    "state", "edges", "queue", "in-flight", "interest", "index", "ring",
    "pool", "scratch",
)

#: findings kept per census (oldest evicted)
MAX_FINDINGS = 64
#: bounded referrer identification (per finding)
REFERRER_BREADTH = 8
REFERRER_DEPTH = 3
SAMPLE_MEMBERS = 3


def census_check_enabled() -> bool:
    """``DTPU_CENSUS_CHECK`` — same spelling as the mirror/native parity
    switches: unset/0/false/off/no = off, anything else = on."""
    v = os.environ.get("DTPU_CENSUS_CHECK", "")
    return v.lower() not in ("", "0", "false", "off", "no")


class CensusParityError(AssertionError):
    """A maintained counter diverged from its verification walk."""


class CensusResidueError(AssertionError):
    """A quiescent control plane retained non-allowlisted state."""


class Family:
    """One registered container family."""

    __slots__ = (
        "name", "kind", "probe", "walk", "cost", "allow", "reason",
        "sample", "containers", "attrs", "last", "last_ts", "slope",
        "flagged",
    )

    def __init__(self, name: str, probe: Callable[[], int], *,
                 kind: str = "state", cost: str = "o1",
                 walk: Callable[[], int] | None = None,
                 allow: bool = False, reason: str = "",
                 sample: Callable[[], Iterable[Any]] | None = None,
                 containers: Callable[[], Iterable[Any]] | None = None,
                 attrs: tuple[str, ...] = ()):
        assert kind in FAMILY_KINDS, kind
        assert cost in ("o1", "walk"), cost
        assert not allow or reason, f"allowlisted family {name} needs a reason"
        self.name = name
        self.kind = kind
        self.probe = probe
        self.walk = walk
        self.cost = cost
        self.allow = allow
        self.reason = reason
        self.sample = sample
        self.containers = containers
        self.attrs = attrs
        # sentinel state (mutated in place by tick — no allocation)
        self.last = 0
        self.last_ts = 0.0
        self.slope = 0.0
        self.flagged = False


class StateCensus:
    """Typed inventory of one control plane's long-lived containers.

    One per state machine (``SchedulerState.census``, worker
    ``WorkerState.census``), built by the role builders below.  Probes
    are closures over the owning state; everything here is read-only
    with respect to the state itself.
    """

    def __init__(self, role: str, clock: Callable[[], float] | None = None):
        self.role = role
        self.clock = clock if clock is not None else time
        self.families: dict[str, Family] = {}
        #: families whose non-zero count means "work in motion" — all
        #: zero = the control plane is quiescent
        self.motion: tuple[str, ...] = ()
        #: state-attribute allowlist for the registration-completeness
        #: gate: container attrs deliberately NOT census-registered,
        #: each with a mandatory reason (tests/test_census.py)
        self.attr_allowlist: dict[str, str] = {}
        self.check = census_check_enabled()
        self.audits = 0
        self.audit_failures = 0
        self.findings_total = 0
        self.findings: deque[dict] = deque(maxlen=MAX_FINDINGS)
        self.sentinel: RetentionSentinel | None = None

    # -------------------------------------------------------- registration

    def register(self, name: str, probe: Callable[[], int], **kwargs: Any) -> None:
        assert name not in self.families, f"duplicate census family {name}"
        self.families[name] = Family(name, probe, **kwargs)

    def allow_attr(self, attr: str, reason: str) -> None:
        assert reason, f"attr allowlist entry {attr} needs a reason"
        self.attr_allowlist[attr] = reason

    def covered_attrs(self) -> set[str]:
        """State attributes accounted for: census-registered or
        allowlisted-with-reason (the registration-completeness gate)."""
        out = set(self.attr_allowlist)
        for fam in self.families.values():
            out.update(fam.attrs)
        return out

    # ------------------------------------------------------------- reading

    def counts(self, deep: bool = False) -> dict[str, int]:
        """Per-family member counts.  ``deep=False`` reads only the
        O(1)/maintained probes; ``deep=True`` adds the O(n) walk-cost
        families (quiesce gates, ``/census?deep=1``, audits)."""
        return {
            name: fam.probe()
            for name, fam in self.families.items()
            if deep or fam.cost == "o1"
        }

    def quiesced(self) -> bool:
        """No tasks, nothing in flight — every motion family reads 0."""
        fams = self.families
        return all(fams[name].probe() == 0 for name in self.motion)

    # -------------------------------------------------- walk-vs-counter

    def audit(self, raise_: bool = True) -> list[dict]:
        """Recount every family that declared a verification walk and
        compare against its maintained probe (mirror-parity style).
        Returns the mismatches; raises :class:`CensusParityError` when
        ``raise_`` (the ``DTPU_CENSUS_CHECK`` mode and the sim gates)."""
        self.audits += 1
        mismatches = []
        for fam in self.families.values():
            if fam.walk is None:
                continue
            counted = fam.probe()
            walked = fam.walk()
            if counted != walked:
                mismatches.append({
                    "family": fam.name, "counted": counted, "walked": walked,
                })
        if mismatches:
            self.audit_failures += 1
            if raise_:
                raise CensusParityError(
                    f"{self.role} census counter/walk drift: {mismatches}"
                )
        return mismatches

    # ------------------------------------------------------- quiesce diff

    def residue(self, extra_allow: Iterable[str] = ()) -> list[dict]:
        """Census-vs-empty-baseline diff at quiesce: every family whose
        deep count is non-zero and that is neither allowlisted at
        registration nor named in ``extra_allow`` becomes a finding.
        Findings are recorded (bounded) and counted; enrich with
        :meth:`enrich_findings` (off-loop in live servers) to attach the
        member sample and the ``gc.get_referrers`` holder chain."""
        extra = set(extra_allow)
        now = self.clock()
        out = []
        for fam in self.families.values():
            if fam.allow or fam.name in extra:
                continue
            n = fam.probe()
            if n:
                out.append({
                    "v": CENSUS_SCHEMA_VERSION,
                    "type": "census-finding",
                    "ts": now,
                    "role": self.role,
                    "family": fam.name,
                    "kind": fam.kind,
                    "count": n,
                })
        for f in out:
            self.findings.append(f)
        self.findings_total += len(out)
        return out

    def enrich_findings(self, findings: list[dict]) -> list[dict]:
        """Attach a bounded member sample and referrer-derived holder
        identification to findings IN PLACE.  Runs ``gc.get_referrers``
        — keep it off the event loop (the scheduler server submits this
        to its executor; sim gates call it synchronously)."""
        for f in findings:
            fam = self.families.get(f.get("family", ""))
            if fam is None or "holders" in f:
                continue
            # defensive per-finding: when enrichment runs off-loop the
            # event loop may mutate the sampled container concurrently
            # (dict-changed-size mid-iteration) — a lost sample must
            # degrade the finding, never lose it or kill the thread
            try:
                members = []
                if fam.sample is not None:
                    for obj in fam.sample():
                        members.append(_safe_repr(obj))
                        if len(members) >= SAMPLE_MEMBERS:
                            break
                f["sample"] = members
                holders: list[str] = []
                if fam.sample is not None:
                    for obj in fam.sample():
                        holders = self.identify_holders(obj)
                        break
                f["holders"] = holders
            except Exception as exc:  # graft-lint: allow[swallowed-exceptions] diagnostics must degrade, not raise — the partial finding records why
                f.setdefault("sample", [])
                f["holders"] = [f"<enrich-failed: {type(exc).__name__}>"]
        return findings

    def identify_holders(self, obj: Any) -> list[str]:
        """Bounded BFS over ``gc.get_referrers`` naming which registered
        containers (or, failing that, which container types) hold
        ``obj`` — the "who is pinning this" answer a leak finding needs.
        Depth/breadth capped; never raises."""
        registry: list[tuple[str, Any]] = []
        for fam in self.families.values():
            if fam.containers is None:
                continue
            try:
                for c in fam.containers():
                    registry.append((fam.name, c))
            except Exception:  # graft-lint: allow[swallowed-exceptions] a torn-down component's container fn must not break diagnostics
                continue
        out: list[str] = []
        seen: set[int] = set()
        frontier = [obj]
        for _depth in range(REFERRER_DEPTH):
            nxt: list[Any] = []
            for o in frontier:
                try:
                    refs = gc.get_referrers(o)
                except Exception:  # graft-lint: allow[swallowed-exceptions] diagnostics must degrade, not raise
                    refs = []
                for r in refs[:REFERRER_BREADTH * 4]:
                    if id(r) in seen or r is frontier or r is nxt:
                        continue
                    seen.add(id(r))
                    named = False
                    for fname, c in registry:
                        if r is c:
                            if fname not in out:
                                out.append(fname)
                            named = True
                            break
                    if named:
                        continue
                    if isinstance(r, (dict, list, set, frozenset, tuple, deque)):
                        if len(nxt) < REFERRER_BREADTH:
                            nxt.append(r)
                    elif hasattr(type(r), "__mro__") and not _is_frame(r):
                        tag = f"<{type(r).__module__}.{type(r).__name__}>"
                        if tag not in out and len(out) < REFERRER_BREADTH:
                            out.append(tag)
            if out or not nxt:
                break
            frontier = nxt
        return out

    # ----------------------------------------------------------- snapshot

    def snapshot(self, deep: bool = False, now: float | None = None) -> list[dict]:
        """JSON-safe records for ``/census`` and cluster dumps: one head
        record, one record per family (counts, slope, allowlist status),
        then the recent findings.  One monotonic ``ts`` per snapshot so
        records line up with flight-recorder events on the same clock."""
        if now is None:
            now = self.clock()
        head = {
            "v": CENSUS_SCHEMA_VERSION,
            "type": "census-head",
            "ts": now,
            "role": self.role,
            "families": len(self.families),
            "quiesced": self.quiesced(),
            "deep": bool(deep),
            "audits": self.audits,
            "audit_failures": self.audit_failures,
            "findings_total": self.findings_total,
        }
        out = [head]
        for fam in self.families.values():
            if not deep and fam.cost != "o1":
                continue
            rec = {
                "v": CENSUS_SCHEMA_VERSION,
                "type": "census",
                "ts": now,
                "role": self.role,
                "family": fam.name,
                "kind": fam.kind,
                "count": fam.probe(),
                "slope": round(fam.slope, 3),
            }
            if fam.allow:
                rec["allow"] = fam.reason
            out.append(rec)
        out.extend(self.findings)
        return out


def _safe_repr(obj: Any, limit: int = 120) -> str:
    try:
        r = repr(obj)
    except Exception:  # graft-lint: allow[swallowed-exceptions] diagnostics must degrade, not raise
        r = f"<unreprable {type(obj).__name__}>"
    return r if len(r) <= limit else r[: limit - 3] + "..."


def _is_frame(obj: Any) -> bool:
    return type(obj).__name__ == "frame"


# ---------------------------------------------------------------- sentinel


class RetentionSentinel:
    """Live leak detection over a census: per-family growth-slope EWMAs
    plus quiesce-edge residue checks.

    ``tick`` is the periodic entry (server ``PeriodicCallback`` at
    ``scheduler.census.interval``; allocation-free per the bench-smoke
    gate): it reads every cheap probe, folds the members-per-second
    slope into an EWMA, and flags families whose slope stays above
    ``scheduler.census.slope-threshold`` while holding at least
    ``scheduler.census.min-count`` members — each flag emits ONE
    flight-recorder ``leak`` event (re-armed when the slope halves).
    When the plane goes quiescent, the census-vs-empty-baseline diff
    runs once per quiesce edge; fresh findings are returned so the
    caller can enrich them off-loop."""

    def __init__(self, census: StateCensus, trace: Any = None, *,
                 alpha: float = 0.3,
                 slope_threshold: float | None = None,
                 min_count: int | None = None,
                 quiesce_allow: Iterable[str] = ()):
        self.census = census
        self.trace = trace
        self.alpha = alpha
        if slope_threshold is None:
            slope_threshold = float(config.get("scheduler.census.slope-threshold"))
        if min_count is None:
            min_count = int(config.get("scheduler.census.min-count"))
        self.slope_threshold = slope_threshold
        self.min_count = min_count
        #: families exempted from LIVE quiesce diffs only (e.g. the
        #: durability dirty sets, drained by snapshot cadence rather
        #: than at the instant of quiesce) — the sim/bench teardown
        #: gates snapshot first and pass nothing here
        self.quiesce_allow = tuple(quiesce_allow)
        self.leaks_flagged = 0
        self.ticks = 0
        self._was_quiesced = True
        # cheap-probe tuple snapshot: tick iterates families directly
        # (no dict build on the periodic path)
        self._cheap = tuple(
            f for f in census.families.values() if f.cost == "o1"
        )

    def tick(self, now: float | None = None) -> list[dict]:
        """One sentinel pass; returns NEW findings (usually empty)."""
        c = self.census
        if now is None:
            now = c.clock()
        self.ticks += 1
        alpha = self.alpha
        thr = self.slope_threshold
        floor = self.min_count
        trace = self.trace
        for fam in self._cheap:
            n = fam.probe()
            dt = now - fam.last_ts
            if fam.last_ts > 0.0 and dt > 0.0:
                fam.slope += alpha * ((n - fam.last) / dt - fam.slope)
            fam.last = n
            fam.last_ts = now
            if fam.slope > thr and n >= floor:
                if not fam.flagged:
                    fam.flagged = True
                    self.leaks_flagged += 1
                    if trace is not None:
                        trace.emit("leak", fam.name, "", n=n)
            elif fam.flagged and fam.slope < thr / 2.0:
                fam.flagged = False
        if c.check:
            c.audit()
        quiesced = c.quiesced()
        fresh: list[dict] = []
        if quiesced and not self._was_quiesced:
            fresh = c.residue(extra_allow=self.quiesce_allow)
            if trace is not None:
                for f in fresh:
                    trace.emit("leak", f["family"], "", n=f["count"])
        self._was_quiesced = quiesced
        return fresh


# ------------------------------------------------------------- role builders
#
# Every dict/set/deque/list attribute either of the two ``__init__``
# bodies assigns must be covered here — census-registered via ``attrs``
# or allowlisted with a reason — or tests/test_census.py's
# registration-completeness gate fails the build.


def _walk_edges(tasks: dict, field: str) -> Callable[[], int]:
    def walk() -> int:
        return sum(len(getattr(ts, field)) for ts in tasks.values())
    return walk


def build_scheduler_census(state: Any) -> StateCensus:
    """Register every long-lived container of one ``SchedulerState``
    (plus the extension/engine/diagnostic structures hanging off it).
    Probes read through ``state`` lazily, so components attached after
    ``__init__`` (stealing, durability, spans) are covered the moment
    they exist."""
    c = StateCensus("scheduler", clock=state.clock)
    tasks = state.tasks

    # ---- first-class records
    c.register(
        "tasks", lambda: len(tasks), kind="state",
        sample=lambda: tasks.values(),
        containers=lambda: (tasks,),
        attrs=("tasks",),
    )
    # maintained-counter twin of ``tasks``: both transition engines
    # maintain TaskGroup.states per arm (`_count_transition` and the
    # native tape appliers); summing the non-forgotten buckets must
    # always equal a from-scratch walk of ``state.tasks`` — THE
    # walk-vs-counter audit that catches a missed engine count
    def _counted_tasks() -> int:
        return sum(
            n
            for tg in state.task_groups.values()
            for s, n in tg.states.items()
            if s != "forgotten" and n
        )

    # O(#groups) per probe — vocabulary-bounded (one group per key
    # prefix), cheap enough for the tick/scrape surface
    c.register(
        "tasks.counted", _counted_tasks, kind="state",
        walk=lambda: len(tasks),
    )
    c.register(
        "groups", lambda: len(state.task_groups), kind="state",
        allow=True, reason="per-group duration/type history persists by "
        "design (bounded by the key-group vocabulary)",
        attrs=("task_groups",),
    )
    # a group may legitimately outlive its tasks, but it must not pin a
    # REMOVED WorkerState via last_worker (cleared on worker removal;
    # regression-tested)
    c.register(
        "groups.stale-last-worker",
        lambda: sum(
            1
            for tg in state.task_groups.values()
            if tg.last_worker is not None
            and state.workers.get(tg.last_worker.address) is not tg.last_worker
        ),
        kind="index", cost="walk",
        sample=lambda: (
            tg.last_worker
            for tg in state.task_groups.values()
            if tg.last_worker is not None
            and state.workers.get(tg.last_worker.address) is not tg.last_worker
        ),
    )
    c.register(
        "prefixes", lambda: len(state.task_prefixes), kind="state",
        allow=True, reason="per-prefix duration priors persist by design "
        "(bounded by the key-prefix vocabulary)",
        attrs=("task_prefixes",),
    )
    c.register(
        "computations", lambda: len(state.computations), kind="ring",
        allow=True,
        reason="bounded deque (diagnostics.computations.max-history)",
        attrs=("computations",),
    )
    c.register(
        "tasks.unknown-durations",
        lambda: len(state.unknown_durations), kind="index",
        containers=lambda: (state.unknown_durations,),
        attrs=("unknown_durations",),
    )
    c.register(
        "tasks.unknown-durations.members",
        lambda: sum(len(s) for s in state.unknown_durations.values()),
        kind="index",
        sample=lambda: (
            ts for s in state.unknown_durations.values() for ts in s
        ),
        containers=lambda: (
            state.unknown_durations,
            *state.unknown_durations.values(),
        ),
    )
    c.register(
        "tasks.replicated", lambda: len(state.replicated_tasks),
        kind="index",
        sample=lambda: state.replicated_tasks,
        containers=lambda: (state.replicated_tasks,),
        attrs=("replicated_tasks",),
    )
    c.register(
        "tasks.metadata", lambda: len(state.task_metadata), kind="state",
        allow=True, reason="client-set task metadata persists until "
        "explicitly deleted (reference semantics)",
        attrs=("task_metadata",),
    )

    # ---- relation-set edges (O(n) walks; zero whenever tasks is zero)
    for field in ("dependencies", "dependents", "waiters", "waiting_on",
                  "who_has"):
        c.register(
            f"edges.{field.replace('_', '-')}",
            _walk_edges(tasks, field), kind="edges", cost="walk",
        )
    c.register(
        "edges.who-wants", _walk_edges(tasks, "who_wants"),
        kind="edges", cost="walk",
    )

    # ---- client interest
    c.register(
        "clients", lambda: len(state.clients), kind="state",
        allow=True, reason="connected clients persist until they "
        "disconnect (their interest edges must still drain to zero)",
        attrs=("clients",),
    )
    c.register(
        "interest.wants",
        lambda: sum(len(cs.wants_what) for cs in state.clients.values()),
        kind="interest", cost="walk",
        sample=lambda: (
            ts for cs in state.clients.values() for ts in cs.wants_what
        ),
        containers=lambda: tuple(
            cs.wants_what for cs in state.clients.values()
        ),
    )

    # ---- queues
    c.register(
        "queue.queued", lambda: len(state.queued), kind="queue",
        sample=lambda: iter(state.queued),
        containers=lambda: (state.queued, state.queued._data),
        attrs=("queued",),
    )
    c.register(
        "queue.unparked", lambda: len(state.queued_unparked), kind="queue",
        containers=lambda: (state.queued_unparked._data,),
        attrs=("queued_unparked",),
    )
    c.register(
        "queue.parked",
        lambda: sum(len(h) for h in state.parked.values()), kind="queue",
        sample=lambda: (
            ts for h in state.parked.values() for ts in h
        ),
        containers=lambda: (state.parked,),
    )
    c.register(
        "queue.parked-heaps", lambda: len(state.parked), kind="queue",
        attrs=("parked",),
    )
    c.register(
        "queue.parked-keys", lambda: len(state._parked_keys), kind="index",
        walk=lambda: sum(len(h) for h in state.parked.values()),
        containers=lambda: (state._parked_keys,),
        attrs=("_parked_keys",),
    )
    c.register(
        "queue.unrunnable", lambda: len(state.unrunnable), kind="queue",
        sample=lambda: state.unrunnable.keys(),
        containers=lambda: (state.unrunnable,),
        attrs=("unrunnable",),
    )

    # ---- fleet
    workers = state.workers
    c.register(
        "workers", lambda: len(workers), kind="state",
        allow=True, reason="registered workers persist until removal",
        sample=lambda: workers.values(),
        containers=lambda: (workers,),
        attrs=("workers",),
    )
    c.register(
        "fleet.aliases", lambda: len(state.aliases), kind="index",
        allow=True, reason="one name alias per registered worker "
        "(pruned on removal)",
        attrs=("aliases",),
    )
    c.register(
        "fleet.hosts", lambda: len(state.host_info), kind="state",
        attrs=("host_info",),
    )
    c.register(
        "fleet.resources",
        lambda: sum(len(d) for d in state.resources.values()),
        kind="index",
        allow=True, reason="per-resource supply rows mirror registered "
        "workers (pruned on removal)",
        attrs=("resources",),
    )
    # idle/saturated/running mirror the registered fleet — allowlisted
    # as counts, but a member that is NOT a registered worker is
    # retained garbage: fleet.stale walks all four
    c.register(
        "fleet.idle", lambda: len(state.idle), kind="index",
        allow=True, reason="subset view of registered workers",
        attrs=("idle",),
    )
    c.register(
        "fleet.idle-task-count", lambda: len(state.idle_task_count),
        kind="index",
        allow=True, reason="subset view of registered workers",
        attrs=("idle_task_count",),
    )
    c.register(
        "fleet.saturated", lambda: len(state.saturated), kind="index",
        allow=True, reason="subset view of registered workers",
        attrs=("saturated",),
    )
    c.register(
        "fleet.running", lambda: len(state.running), kind="index",
        allow=True, reason="subset view of registered workers",
        attrs=("running",),
    )

    def _fleet_stale() -> int:
        live = set(map(id, workers.values()))
        return sum(
            1
            for coll in (state.idle.values(), state.idle_task_count,
                         state.saturated, state.running)
            for ws in coll
            if id(ws) not in live
        )

    c.register(
        "fleet.stale", _fleet_stale, kind="index", cost="walk",
        sample=lambda: (
            ws
            for coll in (state.idle.values(), state.idle_task_count,
                         state.saturated, state.running)
            for ws in coll
            if state.workers.get(ws.address) is not ws
        ),
    )
    c.register(
        "fleet.nthreads-history",
        lambda: len(state.total_nthreads_history), kind="ring",
        allow=True, reason="bounded deque of fleet-capacity flips",
        attrs=("total_nthreads_history",),
    )
    # per-worker mirrors of task state: all drain to zero with the tasks
    for field, kind in (
        ("has_what", "edges"), ("processing", "in-flight"),
        ("executing", "in-flight"), ("long_running", "index"),
        ("actors", "index"),
    ):
        c.register(
            f"fleet.{field.replace('_', '-')}",
            (lambda f=field: sum(
                len(getattr(ws, f)) for ws in workers.values()
            )),
            kind=kind, cost="walk",
            sample=(lambda f=field: (
                ts for ws in workers.values() for ts in getattr(ws, f)
            )),
        )

    # ---- transition engine scratch + logs
    c.register(
        "transition-log", lambda: len(state.transition_log), kind="ring",
        allow=True, reason="bounded deque "
        "(scheduler.transition-log-length)",
        attrs=("_transition_log",),
    )
    c.register(
        "events",
        lambda: sum(len(dq) for dq in state.events.values()), kind="ring",
        allow=True, reason="bounded per-topic deques "
        "(scheduler.events-log-length)",
        attrs=("events", "event_counts"),
    )
    c.register(
        "engine-shards", lambda: len(state.engine_shards), kind="state",
        allow=True, reason="one stat row per mesh shard",
        attrs=("engine_shards",),
    )
    c.register(
        "plugins", lambda: len(state.plugins), kind="state",
        allow=True, reason="installed scheduler plugins persist",
        attrs=("plugins",),
    )
    c.register(
        "extensions", lambda: len(state.extensions), kind="state",
        allow=True, reason="installed scheduler extensions persist",
        attrs=("extensions",),
    )

    # ---- stealing (extension; probes no-op until it attaches)
    def _steal(attr: str, default: Any = None) -> Any:
        # getattr with default so a stub extension (tests) reads empty
        ext = state.extensions.get("stealing")
        return getattr(ext, attr, default) if ext is not None else default

    c.register(
        "steal.stealable",
        lambda: sum(
            len(level)
            for levels in _steal("stealable", {}).values()
            for level in levels
        ),
        kind="index", cost="walk",
        sample=lambda: (
            ts
            for levels in _steal("stealable", {}).values()
            for level in levels
            for ts in level
        ),
    )
    c.register(
        "steal.stealable-workers",
        lambda: len(_steal("stealable", {})), kind="index",
        allow=True, reason="one level-set vector per registered worker "
        "(pruned on removal)",
    )
    c.register(
        "steal.key-stealable",
        lambda: len(_steal("key_stealable", {})), kind="index",
        containers=lambda: tuple(
            x for x in (_steal("key_stealable", None),) if x is not None
        ),
    )
    c.register(
        "steal.in-flight", lambda: len(_steal("in_flight", {})),
        kind="in-flight",
        sample=lambda: _steal("in_flight", {}).values(),
        containers=lambda: tuple(
            x for x in (_steal("in_flight", None),) if x is not None
        ),
    )
    c.register(
        "steal.in-flight-occupancy",
        lambda: len(_steal("in_flight_occupancy", {})), kind="scratch",
        sample=lambda: _steal("in_flight_occupancy", {}).keys(),
    )
    c.register(
        "steal.in-flight-tasks",
        lambda: len(_steal("in_flight_tasks", {})), kind="scratch",
        sample=lambda: _steal("in_flight_tasks", {}).keys(),
    )
    c.register(
        "steal.log", lambda: len(_steal("log", ())), kind="ring",
        allow=True, reason="bounded deque",
    )

    # ---- decision ledger
    led = state.ledger
    c.register(
        "ledger.open", lambda: led.open_rows, kind="in-flight",
        walk=lambda: sum(
            1
            for off in range(0, len(led._ring), _LEDGER_W)
            if led._ring[off] >= 0 and led._ring[off + _LEDGER_OUTCOME] == ""
        ),
    )
    c.register(
        "ledger.amm-open", lambda: len(led._open_amm), kind="in-flight",
        sample=lambda: led._open_amm.keys(),
        containers=lambda: (led._open_amm,),
    )
    c.register(
        "ledger.ring", lambda: len(led), kind="ring",
        allow=True, reason="bounded decision ring (scheduler.ledger.size)",
    )
    c.register(
        "ledger.aggregates",
        lambda: len(led.prefix_agg) + len(led.link_agg)
        + len(led._kind_stats),
        kind="state",
        allow=True, reason="per-prefix/per-link/per-kind regret "
        "aggregates persist by design (bounded by vocabulary x fleet)",
    )

    # ---- telemetry
    tel = state.telemetry
    c.register(
        "telemetry.links", lambda: len(tel.links), kind="state",
        allow=True, reason="per-link EWMAs for the live fleet persist "
        "by design (stale endpoints walk-audited to zero)",
    )

    def _stale_links() -> int:
        # EITHER endpoint unregistered = stale: forget_worker prunes on
        # either side, and the dominant leak shape is a live reporter
        # re-creating a link to a dead peer
        return sum(
            1
            for (src, dst) in tel.links
            if src not in workers or dst not in workers
        )

    c.register(
        "telemetry.links.stale", _stale_links, kind="index", cost="walk",
        sample=lambda: (
            link for (src, dst), link in tel.links.items()
            if src not in workers or dst not in workers
        ),
        containers=lambda: (tel.links,),
    )
    c.register(
        "telemetry.rtt", lambda: len(tel.rtt), kind="index",
        allow=True, reason="per-worker heartbeat RTT EWMAs (pruned on "
        "worker removal; stale endpoints walk-audited to zero)",
    )
    c.register(
        "telemetry.rtt.stale",
        lambda: sum(1 for w in tel.rtt if w not in workers),
        kind="index", cost="walk",
    )
    c.register(
        "telemetry.priors", lambda: len(tel.priors), kind="state",
        allow=True, reason="per-prefix priors persist by design "
        "(bounded by the key-prefix vocabulary)",
    )
    c.register(
        "telemetry.pending-delta", lambda: len(tel.since_heartbeat),
        kind="scratch",
        allow=True, reason="scheduler-side collector never fills its "
        "own delta buffer (worker heartbeats fold through fold_rows)",
    )

    # ---- fleet mirror
    def _mirror(attr: str, default: Any = ()) -> Any:
        m = state.mirror
        return getattr(m, attr) if m is not None else default

    c.register(
        "mirror.slots-live",
        lambda: sum(1 for ws in _mirror("ws_of") if ws is not None),
        kind="state", cost="walk",
        walk=lambda: len(workers) if state.mirror is not None else 0,
        allow=True, reason="one live slot per registered worker "
        "(walk-audited against the worker count)",
    )
    c.register(
        "mirror.tombstones", lambda: len(_mirror("_free", ())),
        kind="pool",
        allow=True, reason="LIFO slot free-list, reused by the next "
        "registration (bounded by capacity)",
    )
    c.register(
        "mirror.dirty",
        lambda: len(_mirror("_dirty", ())) + len(_mirror("_device_dirty", ()))
        + len(_mirror("_sdev_dirty", ())),
        kind="scratch",
        allow=True, reason="dirty row marks pending the next device "
        "refresh (bounded by mirror capacity; slot ints, not object refs)",
    )

    # ---- native engine
    def _native(attr: str, default: Any = ()) -> Any:
        n = state.native
        return getattr(n, attr) if n is not None else default

    c.register(
        "native.rows-live",
        lambda: len(_native("_rows", ())) - len(_native("_row_free", ())),
        kind="state",
        walk=lambda: sum(1 for ts in tasks.values() if ts.nrow >= 0)
        if state.native is not None else 0,
        sample=lambda: (ts for ts in _native("_rows") if ts is not None),
    )
    c.register(
        "native.row-free", lambda: len(_native("_row_free", ())),
        kind="pool",
        allow=True, reason="SoA row free-list, reused by the next task",
    )
    c.register(
        "native.wslot-tombstones",
        lambda: sum(1 for ws in _native("_wslots") if ws is None),
        kind="pool", cost="walk",
        allow=True, reason="worker slots are never reused by design "
        "(one null entry per departed worker)",
    )
    c.register(
        "native.dirty", lambda: len(_native("_dirty", ())), kind="scratch",
        sample=lambda: iter(_native("_dirty", ())),
        containers=lambda: tuple(
            x for x in (_native("_dirty", None),) if x is not None
        ),
    )
    c.register(
        "native.dirty-workers", lambda: len(_native("_dirty_workers", ())),
        kind="scratch",
        allow=True, reason="worker resync marks pending the next flood "
        "flush (bounded by the registered fleet)",
    )
    c.register(
        "native.interned",
        lambda: len(_native("_prefix_ids", ())) + len(_native("_group_ids", ())),
        kind="state",
        allow=True, reason="interned prefix/group id maps (bounded by "
        "the key vocabulary)",
    )
    # authoritative-SoA families (deferred materialization): parked
    # segments must drain to zero at quiesce (every release goes
    # through a sync-first mutation hook), and the hydrated python
    # rows — the "hydration cache" — must empty with the tasks
    c.register(
        "native.pending-segments",
        lambda: len(_native("_pending", ())), kind="scratch",
    )
    c.register(
        "native.tape-pool", lambda: len(_native("_tape_pool", ())),
        kind="pool",
        allow=True, reason="recycled tape buffers (bounded: one per "
        "concurrently-deferred segment, reused across floods)",
    )

    def _eng_counts(i: int) -> int:
        # live-row counts read from the C++ side: the authoritative
        # store's own accounting, audited against a python-mirror walk
        n = state.native
        if n is None or n.h is None:
            return 0
        import ctypes as _ct
        out = (_ct.c_int64 * 6)()
        n.lib.eng_counts(n.h, out)
        return int(out[i])

    c.register(
        "native.soa-rows", lambda: _eng_counts(0), kind="state",
        cost="walk",
        # rows allocated but never yet flushed (_fresh) are python-only:
        # subtract them so the walk matches the C++ live count exactly
        walk=lambda: sum(1 for ts in _native("_rows") if ts is not None)
        - len(_native("_fresh", ())),
        sample=lambda: (ts for ts in _native("_rows") if ts is not None),
    )
    c.register(
        "native.soa-workers", lambda: _eng_counts(2), kind="state",
        cost="walk",
        walk=lambda: sum(1 for ws in _native("_wslots") if ws is not None),
        allow=True, reason="one live SoA slot per registered worker "
        "(drains on worker close, not task release)",
    )
    c.register(
        "native.hydration-cache",
        lambda: (
            max(0, sum(1 for ts in _native("_rows") if ts is not None)
                - sum(p[1] for p in _native("_pending", ())))
        ),
        kind="state", cost="walk",
        sample=lambda: (ts for ts in _native("_rows") if ts is not None),
    )

    # ---- durability (attached by the server / sim when enabled)
    def _durability(attr: str) -> int:
        d = state.durability
        return len(getattr(d, attr)) if d is not None else 0

    for attr in ("dirty_tasks", "removed_tasks", "dirty_workers",
                 "removed_workers"):
        c.register(
            f"durability.{attr.replace('_', '-')}",
            (lambda a=attr: _durability(a)), kind="scratch",
            sample=(lambda a=attr: iter(
                getattr(state.durability, a) if state.durability is not None
                else ()
            )),
        )

    # ---- flight recorder
    c.register(
        "trace.ring", lambda: len(state.trace), kind="ring",
        allow=True, reason="bounded event ring (scheduler.trace.ring-size)",
    )
    c.register(
        "trace.journal", lambda: len(state.trace.journal), kind="ring",
        allow=True, reason="bounded stimulus journal deque "
        "(scheduler.trace.journal-size)",
    )

    # attrs deliberately NOT census-registered (mandatory reasons):
    c.allow_attr("_transitions_table", "static dispatch table, fixed size")
    c.allow_attr("DEFAULT_TASK_DURATIONS", "static config snapshot")
    c.allow_attr("_arm_phases", "interned per-arm phase names, bounded "
                 "by the transition-arm vocabulary")

    # all O(1) probes: quiesced() runs per sentinel tick AND per
    # /metrics scrape (dtpu_census_quiesced).  fleet.processing is
    # implied zero by tasks == 0 (processing sets hold live
    # TaskStates); a bug breaking that implication is still caught by
    # the quiesce residue scan, which probes every family
    c.motion = (
        "tasks", "queue.queued", "queue.unrunnable", "steal.in-flight",
        "native.pending-segments",
    )
    return c


def build_worker_census(state: Any) -> StateCensus:
    """Register every long-lived container of one worker
    ``WorkerState`` (the scheduler census's twin)."""
    # deref the recorder's clock per read: the sim may re-point it at
    # its VirtualClock after construction
    c = StateCensus("worker", clock=lambda: state.trace.clock())
    tasks = state.tasks

    c.register(
        "wtasks", lambda: len(tasks), kind="state",
        sample=lambda: tasks.values(),
        containers=lambda: (tasks,),
        attrs=("tasks",),
    )
    c.register(
        "wtasks.data", lambda: len(state.data), kind="state",
        sample=lambda: state.data.keys(),
        containers=lambda: (state.data,),
        attrs=("data",),
    )
    c.register(
        "wtasks.actors", lambda: len(state.actors), kind="state",
        containers=lambda: (state.actors,),
        attrs=("actors",),
    )

    # relation edges on the worker machine (walks; zero with zero tasks)
    for field in ("dependencies", "dependents", "waiters",
                  "waiting_for_data", "who_has"):
        c.register(
            f"edges.{field.replace('_', '-')}",
            _walk_edges(tasks, field), kind="edges", cost="walk",
        )

    c.register(
        "queue.ready", lambda: len(state.ready), kind="queue",
        containers=lambda: (state.ready._data,),
        attrs=("ready",),
    )
    c.register(
        "queue.constrained", lambda: len(state.constrained), kind="queue",
        attrs=("constrained",),
    )
    for attr in ("executing", "long_running", "in_flight_tasks",
                 "missing_dep_flight"):
        c.register(
            f"exec.{attr.replace('_', '-')}",
            (lambda a=attr: len(getattr(state, a))), kind="in-flight",
            sample=(lambda a=attr: iter(getattr(state, a))),
            containers=(lambda a=attr: (getattr(state, a),)),
            attrs=(attr,),
        )

    # fetch bookkeeping
    c.register(
        "fetch.data-needed",
        lambda: sum(len(h) for h in state.data_needed.values()),
        kind="queue",
        sample=lambda: (
            ts for h in state.data_needed.values() for ts in h
        ),
        containers=lambda: (state.data_needed,),
    )
    c.register(
        "fetch.data-needed-peers", lambda: len(state.data_needed),
        kind="queue", attrs=("data_needed",),
    )
    c.register(
        "fetch.in-flight-workers", lambda: len(state.in_flight_workers),
        kind="in-flight",
        containers=lambda: (state.in_flight_workers,),
        attrs=("in_flight_workers",),
    )
    c.register(
        "fetch.in-flight-keys",
        lambda: sum(len(s) for s in state.in_flight_workers.values()),
        kind="in-flight", cost="walk",
    )
    c.register(
        "fetch.busy-workers", lambda: len(state.busy_workers),
        kind="scratch",
        sample=lambda: iter(state.busy_workers),
        containers=lambda: (state.busy_workers,),
        attrs=("busy_workers",),
    )
    c.register(
        "fetch.has-what",
        lambda: sum(len(s) for s in state.has_what.values()),
        kind="edges", cost="walk",
    )
    c.register(
        "fetch.has-what-peers", lambda: len(state.has_what), kind="index",
        walk=lambda: sum(
            1 for s in state.has_what.values() if s
        ),
        containers=lambda: (state.has_what,),
        attrs=("has_what",),
    )

    c.register(
        "resources",
        lambda: len(state.total_resources) + len(state.available_resources),
        kind="state",
        allow=True, reason="static resource declarations",
        attrs=("total_resources", "available_resources"),
    )
    c.register(
        "log", lambda: len(state.log), kind="ring",
        allow=True, reason="bounded transition log deque",
        attrs=("log",),
    )
    c.register(
        "stimulus-log", lambda: len(state.stimulus_log), kind="ring",
        allow=True, reason="bounded stimulus log deque",
        attrs=("stimulus_log",),
    )
    c.register(
        "task-counter", lambda: len(state.task_counter), kind="state",
        allow=True, reason="per-prefix lifetime counters (bounded by "
        "the key-prefix vocabulary)",
        attrs=("task_counter",),
    )
    c.register(
        "trace.ring", lambda: len(state.trace), kind="ring",
        allow=True, reason="bounded event ring (scheduler.trace.ring-size)",
    )
    c.register(
        "trace.journal", lambda: len(state.trace.journal), kind="ring",
        allow=True, reason="bounded stimulus journal deque",
    )

    c.allow_attr("_transitions_table", "static dispatch table, fixed size")
    c.allow_attr("_arm_phases", "interned per-arm phase names, bounded "
                 "by the transition-arm vocabulary")

    c.motion = (
        "wtasks", "queue.ready", "queue.constrained", "exec.executing",
        "exec.in-flight-tasks", "fetch.data-needed",
    )
    return c
