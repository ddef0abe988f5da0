"""Decision–outcome ledger: audit every placement/steal/AMM choice
against what actually happened.

The telemetry plane records what the cost model *predicts* (the shadow divergence
monitor) and the self-profiler records where the scheduler *spends its own wall*;
this module joins a **decision** to its **realized outcome** — the
regret signal ROADMAP item 1's payoff gates calibrate against, and the
per-graph answer to "where did the makespan go" (the critical-path
analyzer in ``diagnostics/critical_path.py`` consumes ledger dumps).

One ledger row is one prediction: *"this task will run on worker W,
and the constant model prices its missing-dep transfers at C seconds
(the measured shadow at M)"*.  Rows are filed at

- every placement (``SchedulerState._add_to_processing`` — kind
  ``placement``, or ``plan`` when the task lands on its jax_placement
  plan home),
- every steal decision (``WorkStealing.move_task_request`` files a
  ``steal`` row at request time; the confirm's re-placement supersedes
  it with the definitive ``steal`` row; ``move_task_speculative``
  files ``steal-spec`` directly), and
- every AMM replica decision (``amm-repl`` / ``amm-drop``),

and **joined** when the realized outcome arrives: the task reaches
``memory``/``erred`` (or is released/overtaken), the steal is
confirmed or rejected, the replica lands (``add-keys``) or drops
(``release-worker-data``).  The join computes per-decision **regret**
for both cost models::

    regret_model = (t_join - t_decision - realized_compute) - predicted_comm

i.e. realized non-compute seconds (transfer + queueing + control
latency, on the scheduler's own clock) minus what the model predicted
— observed into ``dtpu_ledger_regret_seconds{kind,model}`` histograms
plus per-prefix and per-link aggregates.  The row also carries a
telemetry-derived realized-transfer estimate for its dominant dep link
(the decision's ``src -> worker`` edge priced with the link EWMAs
*after* the actual transfers folded in), so the critical-path analyzer
can split non-compute time into transfer vs queue.

Lifecycle rules (the telemetry plane's link-leak lesson applied to rows):

- a new decision for a key with an open row **supersedes** it (counted
  ``superseded``, no regret — its prediction was never tested);
- rows whose slot is overwritten by ring wrap before joining age out
  into ``dtpu_ledger_unjoined_total``;
- ``remove_worker_state`` finalizes every open row pointing at the
  departed worker (``worker-removed``) so dead decisions never linger.

Zero per-decision allocation on the hot path: rows live in ONE flat
preallocated ring mutated by slice assignment (the flight-
recorder pattern taken further — no per-slot list objects), gated by
the ``ledger`` bench-smoke ``sys.getallocatedblocks`` check, and task
rows are joined by integer HANDLE parked on the TaskState
(``ts.ledger_row``) instead of a key-hashed index.  With
``digest_enabled`` (the simulator turns it on), every finalized row
folds into a running blake2b digest, so two same-seed simulator runs
produce **bit-identical ledger digests** (tests/test_ledger.py).

This file is pure (no IO, no event loop, no threads): the sans-io
engine imports it, the simulator runs it on virtual time (``clock`` is
injectable like the flight recorder's), and the monotonic-time +
sans-io lints cover it (graft-lint.toml).
"""

from __future__ import annotations

import hashlib
from bisect import bisect_left
from typing import Any

from distributed_tpu_torch import config
from distributed_tpu_torch.tracing import Histogram
from distributed_tpu_torch.utils import time

#: bump when a row field is added/renamed/retyped; every /ledger JSONL
#: record carries it as ``v`` (docs/observability.md)
LEDGER_SCHEMA_VERSION = 1

#: flat slot layout of one ledger row (preallocated, mutated in place)
ROW_FIELDS = (
    "seq",            # lifetime ordinal of the row (ring head)
    "kind",           # decision kind (KINDS)
    "key",            # task key
    "prefix",         # task prefix (per-prefix aggregates key on it)
    "worker",         # the chosen worker address
    "src",            # best holder of the heaviest missing dep ("" = none)
    "stim",           # the decision's stimulus id
    "plan_stim",      # for plan-homed placements: the landed plan's
                      # stimulus (joins the row to its kernel event)
    "t_decision",     # clock at decision time
    "pred_constant",  # constant-model comm cost (get_comm_cost)
    "pred_measured",  # measured-shadow comm cost (get_comm_cost_measured)
    "used_measured",  # 1 = a measured link/RTT actually priced a dep
    "dep_bytes",      # missing-dep payload bytes at decision time
    "n_deps",         # missing deps at decision time
    "duration_pred",  # predicted compute seconds (get_task_duration)
    "t_join",         # clock at join/finalize time (0.0 = still open)
    "outcome",        # OUTCOMES ("" = still open)
    "compute",        # realized compute seconds (worker-reported)
    "transfer",       # realized-transfer estimate for the src link
    "queue",          # realized total - compute - transfer (clamped >=0)
    "regret_constant",  # (total - compute) - pred_constant
    "regret_measured",  # (total - compute) - pred_measured
)

(_SEQ, _KIND, _KEY, _PREFIX, _WORKER, _SRC, _STIM, _PLAN_STIM, _T_DEC,
 _PRED_C, _PRED_M, _USED_M, _DEP_BYTES, _N_DEPS, _DUR_PRED, _T_JOIN,
 _OUTCOME, _COMPUTE, _TRANSFER, _QUEUE, _REG_C, _REG_M) = range(
    len(ROW_FIELDS)
)

#: decision kinds (the regret histograms' ``kind`` label)
KINDS = (
    "placement",   # _add_to_processing (oracle / rootish / queued pop)
    "plan",        # _add_to_processing landing a jax_placement plan home
    "steal",       # move_task_request + the confirm's re-placement
    "steal-spec",  # move_task_speculative's direct re-placement
    "amm-repl",    # AMM replicate suggestion toward a recipient
    "amm-drop",    # AMM drop suggestion at a holder
)

#: terminal outcomes a row can finalize with
OUTCOMES = (
    "memory",          # the placed task completed (regret observed)
    "erred",           # the placed task failed
    "released",        # the placement was cancelled mid-flight
    "superseded",      # a newer decision for the key replaced this row
    "rejected",        # steal request: the victim refused (already running)
    "overtaken",       # joined from a different worker than predicted
                       # (e.g. the victim finished before the steal landed)
    "replicated",      # AMM replica landed (add-keys from the recipient)
    "dropped",         # AMM replica dropped (release-worker-data)
    "worker-removed",  # the chosen worker left before the outcome
)

#: outcomes that observe regret (prediction actually tested end-to-end)
_REGRET_OUTCOMES = ("memory", "replicated")

#: signed regret buckets (seconds): dense around 0 (agreement), decades
#: both ways out to the multi-second mispredictions a 4.2x-off constant
#: produces on big transfers (PERF.md Round 4)
REGRET_BUCKETS = (
    -10.0, -3.0, -1.0, -0.3, -0.1, -0.03, -0.01, 0.0,
    0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0,
)

#: flat per-kind stats layout: 5 scalar aggregates, then the constant
#: and measured bucket-count halves (each len(buckets)+1 for +Inf)
_N_BUCKETS = len(REGRET_BUCKETS) + 1
_M_OFF = 5 + _N_BUCKETS

#: one row's width in the flat ring and its empty template
_W = len(ROW_FIELDS)
_EMPTY_ROW = (
    -1, "", "", "", "", "", "", "", 0.0, 0.0, 0.0, 0, 0, 0,
    0.0, 0.0, "", 0.0, 0.0, 0.0, 0.0, 0.0,
)

#: per-prefix / per-link aggregate caps in summary() output (the row
#: ring itself is the full-fidelity record)
SUMMARY_TOP_N = 32


class DecisionLedger:
    """Bounded decision–outcome ring + open-row join index.

    One per ``SchedulerState`` (``state.ledger``); the simulator's
    virtual clock makes joins exact and deterministic.
    """

    def __init__(self, size: int | None = None,
                 enabled: bool | None = None):
        if size is None:
            size = int(config.get("scheduler.ledger.size"))
        if enabled is None:
            enabled = bool(config.get("scheduler.ledger.enabled"))
        n = 2
        while n < size:
            n <<= 1  # pow2: the hot path masks instead of modding
        self._mask = n - 1
        # injectable clock (the flight-recorder seam): the simulator
        # re-points this at its VirtualClock so decision and join
        # stamps — and therefore regrets and digests — are virtual
        # seconds, bit-identical across same-seed runs
        self.clock = time
        self.enabled = bool(enabled)
        # ONE flat preallocated ring (row i lives at offset
        # (i & mask) * len(ROW_FIELDS)), mutated in place via slice
        # assignment: no per-decision allocation (the bench-smoke
        # ``sys.getallocatedblocks`` gate) and no per-slot list object
        # indirection on the hot path
        self._ring: list = list(_EMPTY_ROW) * n
        self._i = 0  # rows ever filed (ring head)
        # task rows are joined by HANDLE, not by key: ``file`` returns
        # the row's lifetime ordinal and the caller parks it on the
        # TaskState (``ts.ledger_row``) — no string hash, no dict churn
        # on the per-decision hot path.  A handle stays valid while its
        # slot's seq matches and the row is open.  AMM rows keep a
        # (key, worker) dict index: their joins arrive as add-keys /
        # release-worker-data stimuli that carry no handle, and the AMM
        # cadence is seconds, not the flood path.
        self._open_amm: dict[tuple[str, str], int] = {}
        # counters (filed_total, open_rows, joined_total, superseded_
        # total are all DERIVED from these three so the hot file/join
        # pair pays exactly one counter increment each):
        self.unjoined_total = 0    # aged out of the ring while open
        self._memory_joins = 0     # hot-path outcome counter
        self._outcomes: dict[str, int] = {}  # every other outcome
        # per-kind regret stats, ONE flat list per kind so a join pays
        # a single dict hit + list-index increments (the exposition
        # builds Histogram views from the bucket halves at read time):
        # [n, sum_c, sum_m, abs_c, abs_m,
        #  16 constant bucket counts, 16 measured bucket counts]
        self._kind_stats: dict[str, list] = {}
        # prefix -> [n, abs_c, abs_m]
        self.prefix_agg: dict[str, list] = {}
        # (src, dst) -> [n, transfer_s, abs_c, abs_m]
        self.link_agg: dict[tuple[str, str], list] = {}
        # running digest over finalized rows: two same-seed sim runs
        # produce bit-identical hexdigests (the rows themselves wrap).
        # OPT-IN (the simulator sets it): a blake2b fold per join is
        # measurable against the <5% live engine-flood budget, and the
        # digest only means something under a deterministic clock.
        self.digest_enabled = False
        self._h = hashlib.blake2b(digest_size=16)
        # deferred-materialization barrier (docs/native_engine.md
        # "authoritative SoA"): when a native engine attaches it points
        # this at its sync(), and every READ method below calls it first
        # so deferred file/join rows fold into the ring and digest
        # before the read observes them.  None = no native engine.
        self.barrier: Any = None


    # ------------------------------------------------------------- filing
    #
    # file/join are THE hot path (one pair per task placed): positional
    # signatures, inlined writes, locals over attributes — the ledger
    # bench-smoke holds the whole pair under the 5% engine-flood budget
    # and the sys.getallocatedblocks gate.

    def file(self, kind: str, key: str, prefix: str, worker: str,
             stim: str, pred_constant: float = 0.0,
             pred_measured: float = 0.0, used_measured: bool = False,
             dep_bytes: int = 0, n_deps: int = 0,
             duration_pred: float = 0.0, src: str = "",
             plan_stim: str = "", supersede: int = -1,
             now: float | None = None) -> int:
        """File one task-cost decision row (placement/plan/steal kinds)
        and return its handle (park it on the task; join with
        :meth:`join_row`).

        ``supersede``: the task's previously-open row handle, finalized
        as ``superseded`` — its prediction was replaced before reality
        could test it.  Returns -1 when disabled.

        ``now``: decision stamp override.  The native engine's deferred
        replay passes the flood-hoisted clock so ``t_decision`` — which
        the digest folds verbatim — matches what the eager path stamped.
        """
        if not self.enabled:
            return -1
        ring = self._ring
        if supersede >= 0:
            off = (supersede & self._mask) * _W
            if ring[off] == supersede and ring[off + _OUTCOME] == "":
                self._finalize(supersede, "superseded")
        i = self._i
        off = (i & self._mask) * _W
        if ring[off + _OUTCOME] == "" and ring[off] >= 0:
            # ring wrapped over a still-open row: it ages out unjoined
            self._evict_open(off)
        # one C-speed slice assignment covers the prediction half plus
        # the open markers (fields 0.._OUTCOME are laid out contiguous
        # for exactly this); realized fields are NOT reset — they are
        # written at join time, and an open or unjoined row's realized
        # fields are undefined by contract (consumers key on `outcome`)
        ring[off:off + _OUTCOME + 1] = (
            i, kind, key, prefix, worker, src, stim, plan_stim,
            self.clock() if now is None else now, pred_constant,
            pred_measured, 1 if used_measured else 0, dep_bytes, n_deps,
            duration_pred, 0.0, "",
        )
        self._i = i + 1
        return i

    def file_amm(self, kind: str, key: str, worker: str, stim: str, *,
                 pred_constant: float = 0.0, pred_measured: float = 0.0,
                 used_measured: bool = False, nbytes: int = 0,
                 src: str = "") -> None:
        """File one AMM replica decision row (``amm-repl``/``amm-drop``)
        keyed by (key, worker) — one open replica decision per pair.
        Off the flood path (AMM runs on a seconds cadence)."""
        if not self.enabled:
            return
        k = (key, worker)
        old = self._open_amm.get(k)
        if old is not None:
            self._finalize(old, "superseded")
            del self._open_amm[k]
        i = self._i
        ring = self._ring
        off = (i & self._mask) * _W
        if ring[off + _OUTCOME] == "" and ring[off] >= 0:
            self._evict_open(off)
        ring[off:off + _OUTCOME + 1] = (
            i, kind, key, "", worker, src, stim, "",
            self.clock(), pred_constant, pred_measured,
            1 if used_measured else 0, int(nbytes), 0, 0.0, 0.0, "",
        )
        self._i = i + 1
        self._open_amm[k] = i

    def _evict_open(self, off: int) -> None:
        ring = self._ring
        self.unjoined_total += 1
        if ring[off + _KIND].startswith("amm"):
            k = (ring[off + _KEY], ring[off + _WORKER])
            if self._open_amm.get(k) == ring[off]:
                del self._open_amm[k]
        ring[off + _OUTCOME] = "unjoined"

    # ------------------------------------------------------------- joining

    def join_row(self, i: int, outcome: str, worker: str = "",
                 now: float | None = None, compute: float = 0.0,
                 telemetry: Any = None) -> bool:
        """Join the open task row behind handle ``i`` to its realized
        outcome.  A stale handle — the slot was reused by ring wrap, or
        the row already finalized — is a cheap no-op.

        ``worker`` (when given) cross-checks the prediction: a row whose
        chosen worker differs — the victim finished before a steal
        landed — finalizes as ``overtaken`` with no regret, so steal
        regret never absorbs another worker's realization.
        """
        if i < 0:
            return False
        ring = self._ring
        off = (i & self._mask) * _W
        if ring[off] != i or ring[off + _OUTCOME] != "":
            return False
        if worker and ring[off + _WORKER] != worker:
            outcome = "overtaken"
        if outcome == "memory":
            # inlined hot half of _finalize: one join per completed task
            if now is None:
                now = self.clock()
            self._memory_joins += 1
            noncompute = now - ring[off + _T_DEC] - compute
            if ring[off + _N_DEPS] == 0:
                # no missing deps at decision time: BOTH models
                # predicted exactly 0 transfer, so regret would measure
                # pure queue/latency noise — identical for both models,
                # zero calibration signal.  The row still joins (the
                # realized window feeds the critical path); only the
                # regret fold is skipped, keeping regret aggregates a
                # pure audit of transfer predictions.
                ring[off + _T_JOIN:off + _W] = (
                    now, "memory", compute, 0.0,
                    noncompute if noncompute > 0.0 else 0.0, 0.0, 0.0,
                )
                if self.digest_enabled:
                    self._digest_row(off, "memory", now)
                return True
            reg_c = noncompute - ring[off + _PRED_C]
            reg_m = noncompute - ring[off + _PRED_M]
            src = ring[off + _SRC]
            transfer = 0.0
            if src and telemetry is not None and telemetry.links:
                transfer = self._transfer_estimate(
                    src, ring[off + _WORKER], ring[off + _DEP_BYTES],
                    telemetry,
                )
                if noncompute < transfer:
                    transfer = noncompute if noncompute > 0.0 else 0.0
            queue = noncompute - transfer
            # C-speed slice assignment of the whole realized half
            # (fields _T_JOIN.._REG_M are laid out contiguous for this)
            ring[off + _T_JOIN:off + _W] = (
                now, "memory", compute, transfer,
                queue if queue > 0.0 else 0.0, reg_c, reg_m,
            )
            self._observe(off, reg_c, reg_m, transfer)
            if self.digest_enabled:
                self._digest_row(off, "memory", now)
        else:
            self._finalize(i, outcome, now=now, compute=compute,
                           telemetry=telemetry)
        return True

    def join_amm(self, key: str, worker: str, outcome: str, *,
                 now: float | None = None, telemetry: Any = None) -> bool:
        """Join an open AMM row for (key, worker); cheap no-op when no
        AMM decisions are pending (the guard every add-keys /
        release-worker-data stimulus takes)."""
        if not self._open_amm:
            return False
        i = self._open_amm.pop((key, worker), None)
        if i is None:
            return False
        self._finalize(i, outcome, now=now, telemetry=telemetry)
        return True

    def _finalize(self, i: int, outcome: str, *, now: float | None = None,
                  compute: float = 0.0, telemetry: Any = None) -> None:
        ring = self._ring
        off = (i & self._mask) * _W
        if now is None:
            now = self.clock()
        self._outcomes[outcome] = self._outcomes.get(outcome, 0) + 1
        if outcome in _REGRET_OUTCOMES:
            noncompute = now - ring[off + _T_DEC] - compute
            reg_c = noncompute - ring[off + _PRED_C]
            reg_m = noncompute - ring[off + _PRED_M]
            transfer = self._transfer_estimate(
                ring[off + _SRC], ring[off + _WORKER],
                ring[off + _DEP_BYTES], telemetry,
            )
            transfer = min(transfer, max(noncompute, 0.0))
            ring[off + _T_JOIN:off + _W] = (
                now, outcome, compute, transfer,
                max(noncompute - transfer, 0.0), reg_c, reg_m,
            )
            self._observe(off, reg_c, reg_m, transfer)
        else:
            ring[off + _T_JOIN:off + _W] = (
                now, outcome, compute, 0.0, 0.0, 0.0, 0.0,
            )
        if self.digest_enabled:
            self._digest_row(off, outcome, now)

    def _digest_row(self, off: int, outcome: str, now: float) -> None:
        ring = self._ring
        self._h.update(
            f"{ring[off + _SEQ]}\x00{ring[off + _KIND]}\x00"
            f"{ring[off + _KEY]}\x00{ring[off + _WORKER]}\x00"
            f"{outcome}\x00{ring[off + _T_DEC]!r}\x00{now!r}\x00"
            f"{ring[off + _REG_C]!r}\x00{ring[off + _REG_M]!r}\n"
            .encode()
        )

    @staticmethod
    def _transfer_estimate(src: str, dst: str, dep_bytes: int,
                           telemetry: Any) -> float:
        """Realized-transfer estimate for the dominant dep link: the
        row's missing bytes priced with the telemetry link EWMAs as
        they stand at join time — i.e. *after* the fetches this
        decision caused folded their actual transfer records in."""
        if telemetry is None or not src or dep_bytes <= 0:
            return 0.0
        link = telemetry.links.get((src, dst))
        if link is None or not link.bandwidth.count:
            return 0.0
        return (
            dep_bytes / max(link.bandwidth.value, 1e-9)
            + max(link.latency.value, 0.0)
        )

    def _observe(self, off: int, reg_c: float, reg_m: float,
                 transfer: float) -> None:
        """Fold one regret observation into the per-kind stats and the
        per-prefix / per-link aggregates."""
        ring = self._ring
        abs_c = reg_c if reg_c >= 0.0 else -reg_c
        abs_m = reg_m if reg_m >= 0.0 else -reg_m
        kind = ring[off + _KIND]
        st = self._kind_stats.get(kind)
        if st is None:
            st = self._kind_stats[kind] = (
                [0, 0.0, 0.0, 0.0, 0.0] + [0] * (2 * _N_BUCKETS)
            )
        st[0] += 1
        st[1] += reg_c
        st[2] += reg_m
        st[3] += abs_c
        st[4] += abs_m
        st[5 + bisect_left(REGRET_BUCKETS, reg_c)] += 1
        st[_M_OFF + bisect_left(REGRET_BUCKETS, reg_m)] += 1
        prefix = ring[off + _PREFIX]
        if prefix:
            p = self.prefix_agg.get(prefix)
            if p is None:
                p = self.prefix_agg[prefix] = [0, 0.0, 0.0]
            p[0] += 1
            p[1] += abs_c
            p[2] += abs_m
        src = ring[off + _SRC]
        if src:
            lk = (src, ring[off + _WORKER])
            ln = self.link_agg.get(lk)
            if ln is None:
                ln = self.link_agg[lk] = [0, 0.0, 0.0, 0.0]
            ln[0] += 1
            ln[1] += transfer
            ln[2] += abs_c
            ln[3] += abs_m

    @property
    def hists(self) -> dict[tuple[str, str], Histogram]:
        """Read-time Histogram views over the flat per-kind stats (the
        /metrics exposition's shape; built per call, never mutated on
        the hot path)."""
        b = self.barrier
        if b is not None:
            b()
        out: dict[tuple[str, str], Histogram] = {}
        for kind, st in self._kind_stats.items():
            hc = Histogram(REGRET_BUCKETS)
            hc.counts = list(st[5:_M_OFF])
            hc.sum = st[1]
            hc.count = st[0]
            out[(kind, "constant")] = hc
            hm = Histogram(REGRET_BUCKETS)
            hm.counts = list(st[_M_OFF:])
            hm.sum = st[2]
            hm.count = st[0]
            out[(kind, "measured")] = hm
        return out

    @property
    def kind_agg(self) -> dict[str, list]:
        """``kind -> [n, sum_c, sum_m, abs_c, abs_m]`` view."""
        b = self.barrier
        if b is not None:
            b()
        return {k: st[:5] for k, st in self._kind_stats.items()}

    # ----------------------------------------------------------- lifecycle

    def resolve_worker(self, address: str,
                       now: float | None = None) -> int:
        """Finalize every open row whose chosen worker just left
        (``remove_worker_state``) — the telemetry link-leak lesson: dead
        decisions must never linger awaiting a join that cannot come.
        One bounded ring scan per removal (removals are rare; the hot
        path carries no per-worker index)."""
        b = self.barrier
        if b is not None:
            b()
        if not self.open_rows:
            return 0
        ring = self._ring
        n = 0
        for off in range(0, len(ring), _W):
            if (
                ring[off] >= 0 and ring[off + _OUTCOME] == ""
                and ring[off + _WORKER] == address
            ):
                if ring[off + _KIND].startswith("amm"):
                    self._open_amm.pop((ring[off + _KEY], address), None)
                self._finalize(ring[off], "worker-removed", now=now)
                n += 1
        return n

    def resolve_all(self, outcome: str = "released",
                    now: float | None = None) -> int:
        """Finalize every open row (scheduler restart / state clear)."""
        b = self.barrier
        if b is not None:
            b()
        if not self.open_rows:
            return 0
        ring = self._ring
        n = 0
        for off in range(0, len(ring), _W):
            if ring[off] >= 0 and ring[off + _OUTCOME] == "":
                self._finalize(ring[off], outcome, now=now)
                n += 1
        self._open_amm.clear()
        return n

    @property
    def filed_total(self) -> int:
        """Rows ever filed (every file advances the ring head)."""
        b = self.barrier
        if b is not None:
            b()
        return self._i

    @property
    def open_rows(self) -> int:
        """Decisions still awaiting their outcome — derived: filed
        minus every finalized row."""
        b = self.barrier
        if b is not None:
            b()
        return (
            self._i - self._memory_joins - self.unjoined_total
            - sum(self._outcomes.values())
        )

    @property
    def superseded_total(self) -> int:
        b = self.barrier
        if b is not None:
            b()
        return self._outcomes.get("superseded", 0)

    @property
    def joined_total(self) -> int:
        """Rows joined to a realized outcome — derived: every filed row
        is exactly one of open / unjoined / superseded / joined."""
        b = self.barrier
        if b is not None:
            b()
        return (
            self.filed_total - self.open_rows
            - self.unjoined_total - self.superseded_total
        )

    @property
    def outcomes(self) -> dict[str, int]:
        b = self.barrier
        if b is not None:
            b()
        out = dict(self._outcomes)
        if self._memory_joins:
            out["memory"] = self._memory_joins
        return out

    # ------------------------------------------------------------ reading

    def __len__(self) -> int:
        b = self.barrier
        if b is not None:
            b()
        return min(self._i, self._mask + 1)

    def tail(self, n: int | None = None) -> list[dict]:
        """Newest ``n`` (default all resident) rows as dicts, oldest
        first — the /ledger wire format and the dump/analyzer input."""
        b = self.barrier
        if b is not None:
            b()
        total = self._i
        count = min(total, self._mask + 1)
        if n is not None:
            count = min(count, max(int(n), 0))
        ring = self._ring
        out = []
        for j in range(total - count, total):
            off = (j & self._mask) * _W
            rec = dict(zip(ROW_FIELDS, ring[off:off + _W]))
            rec["v"] = LEDGER_SCHEMA_VERSION
            rec["type"] = "ledger-row"
            out.append(rec)
        return out

    def summary(self) -> dict:
        """JSON-safe aggregate: counters, per-kind regret (count / mean
        signed / mean abs, both models), the whole-ledger aggregate-
        regret comparison (the ROADMAP item 1 calibration artifact),
        and bounded per-prefix / per-link aggregates."""
        b = self.barrier
        if b is not None:
            b()
        kinds = {}
        tot_n = 0
        tot_abs_c = tot_abs_m = tot_sum_c = tot_sum_m = 0.0
        for kind, (n, sum_c, sum_m, abs_c, abs_m) in sorted(
            self.kind_agg.items()
        ):
            kinds[kind] = {
                "count": n,
                "regret_mean_constant": sum_c / n,
                "regret_mean_measured": sum_m / n,
                "regret_mean_abs_constant": abs_c / n,
                "regret_mean_abs_measured": abs_m / n,
            }
            tot_n += n
            tot_abs_c += abs_c
            tot_abs_m += abs_m
            tot_sum_c += sum_c
            tot_sum_m += sum_m
        top_prefixes = sorted(
            self.prefix_agg.items(), key=lambda kv: -kv[1][0]
        )[:SUMMARY_TOP_N]
        top_links = sorted(
            self.link_agg.items(), key=lambda kv: -kv[1][0]
        )[:SUMMARY_TOP_N]
        return {
            "v": LEDGER_SCHEMA_VERSION,
            "filed": self.filed_total,
            "joined": self.joined_total,
            "unjoined": self.unjoined_total,
            "superseded": self.superseded_total,
            "open": self.open_rows,
            "outcomes": dict(sorted(self.outcomes.items())),
            "kinds": kinds,
            "regret_abs_mean": {
                "constant": tot_abs_c / tot_n if tot_n else None,
                "measured": tot_abs_m / tot_n if tot_n else None,
            },
            "regret_mean": {
                "constant": tot_sum_c / tot_n if tot_n else None,
                "measured": tot_sum_m / tot_n if tot_n else None,
            },
            "prefixes": {
                p: {
                    "count": v[0],
                    "abs_constant": v[1],
                    "abs_measured": v[2],
                }
                for p, v in top_prefixes
            },
            "links": [
                {
                    "src": src, "dst": dst, "count": v[0],
                    "transfer_s": v[1], "abs_constant": v[2],
                    "abs_measured": v[3],
                }
                for (src, dst), v in top_links
            ],
            "digest": self.digest(),
        }

    def snapshot(self, n: int | None = None) -> list[dict]:
        """The /ledger JSONL payload: one summary record followed by the
        resident row tail."""
        b = self.barrier
        if b is not None:
            b()
        head = self.summary()
        head["type"] = "ledger-summary"
        return [head, *self.tail(n)]

    def digest(self) -> str:
        """Hex digest over every row finalized so far — same seed, same
        workload, same overrides => bit-identical (the sim determinism
        contract extended to decisions-vs-outcomes)."""
        b = self.barrier
        if b is not None:
            b()
        return self._h.hexdigest()

    def __repr__(self) -> str:
        return (
            f"<DecisionLedger {'on' if self.enabled else 'off'} "
            f"ring={self._mask + 1} filed={self.filed_total} "
            f"joined={self.joined_total} open={self.open_rows}>"
        )
