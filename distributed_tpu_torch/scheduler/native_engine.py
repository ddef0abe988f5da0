"""Bridge to the native (C++) transition core — docs/native_engine.md.

``native/engine.cpp`` owns a struct-of-arrays mirror of the scheduler's
task/worker/prefix/group state and executes the four dominant
transition arms (~80% of engine wall per
``docs/state_machine/engine_wall.json``) entirely in C++: decisions,
drain control flow (exact CPython ``dict.popitem`` rec semantics),
occupancy floats and idle/saturated membership flips.  It emits a TAPE;
this bridge replays the tape onto the real ``TaskState``/``WorkerState``
objects with slim per-arm appliers that perform the SAME mutation
sequence the scalar oracle would — the relation fields are
insertion-ordered (``OrderedSet``), so "same sequence" is well-defined
and the C++ vectors mirror it exactly.  Messages, story rows, journal
records, ledger rows and plugin calls are all built from python truth,
which is what makes the output bit-identical to the oracle.

Replay is DEFERRED (the "authoritative SoA" contract,
docs/native_engine.md): a completed native segment stashes its tape
plus context on ``self._pending`` instead of replaying immediately, so
the flood's timed path is just prep + flush + the C++ call.  The SoA is
the source of truth until ``sync()`` replays every pending segment in
original order — triggered by the SoA-backed TaskState/WorkerState
property accessors (``state._NATIVE_PENDING``), the ledger/telemetry
read barriers, the lazy message dicts the drives return, and every
python-side mutation hook below.  Deferral changes WHEN the python
objects materialize, never what they materialize to: replay runs the
same appliers against unchanged starting state, with the flood's
hoisted clock stamp threaded through so ledger digests stay
bit-identical.

Anything an arm needs that the core does not model ESCAPES to the
python oracle per key: the drain stops at a transition boundary, the
tape so far is applied, and the popped transition plus the pending
rec-dict are handed to the real ``_transition``/``_transitions``.
Python-side mutations (escapes, scalar stimuli, steal/AMM, graph
intake) mark rows dirty at the existing mutation helpers; dirty rows
resync into the SoA before the next native segment.

The port's copy of ``distributed_tpu/scheduler/native_engine.py``, line
for line but for one seam: the library is the port's own build of its
byte copy of ``native/engine.cpp`` (``native.load_engine``), and
``attach(build=True)`` raises ``RuntimeError`` when it cannot be built,
where the reference returns None and the scheduler runs the Python oracle
without a word.  ``attach(build=False)`` keeps the reference's "attach if
already built".

Compiled arm set — graft-lint's ``state-machine`` rule asserts this
stays a subset of the extracted scheduler transition table, so a new
arm added in python but missing from C++ is a lint finding, not a perf
cliff:
"""

from __future__ import annotations

import ctypes
import logging
import os
from typing import TYPE_CHECKING, Any

from distributed_tpu_torch import native
from distributed_tpu_torch.protocol.serialize import wrap_opaque
from distributed_tpu_torch.scheduler.state import (
    _NATIVE_PENDING,
    _merge_msgs_inplace as _merge,
)
from distributed_tpu_torch.utils.collections import OrderedSet

if TYPE_CHECKING:  # pragma: no cover
    from distributed_tpu_torch.scheduler.state import (
        SchedulerState, TaskState, WorkerState,
    )

logger = logging.getLogger("distributed_tpu_torch.scheduler.native")

#: the (start, finish) pairs engine.cpp compiles — checked against the
#: extracted scheduler table by analysis/rules/state_machine.py
COMPILED_ARMS = (
    ("released", "waiting"),
    ("waiting", "processing"),
    ("processing", "memory"),
    ("memory", "released"),
)

#: state name <-> enum (must match engine.cpp's State)
STATE_NAMES = (
    "released", "waiting", "no-worker", "queued", "processing", "memory",
    "erred", "forgotten",
)
STATE_IDX = {name: i for i, name in enumerate(STATE_NAMES)}

#: worker status name -> enum (engine.cpp WStatus)
WSTATUS_IDX = {
    "running": 0, "paused": 1, "closing": 2, "closing_gracefully": 3,
    "init": 4, "closed": 5,
}

# task flag bits (engine.cpp Flag)
F_ACTOR, F_RESTRICTED, F_NO_RUNSPEC, F_BLAMED, F_LONG_RUNNING = (
    1, 2, 4, 8, 16,
)

# tape opcodes (engine.cpp Op)
(OP_FREEKEYS_STALE, OP_ADD_REPLICA, OP_PM, OP_WP, OP_MR, OP_RW, OP_FLIP,
 OP_META) = range(8)

R_DONE, R_ESCAPE, R_TAPE_FULL = 0, 1, 2

#: escape-reason names, indexed by engine.cpp EscapeWhy (metrics label)
ESCAPE_WHY = (
    "uncompiled-edge", "actor", "restricted", "rootish", "placement-ext",
    "bare-dep", "no-worker", "forgotten-dep", "event-shape",
)

_COMPILED_SET = frozenset(COMPILED_ARMS)

#: max events handed to one native segment call
SEG_MAX = 65536

#: scheduler.native-engine.min-flood: floods smaller than this run the
#: oracle directly.  Default 0 — the SoA maintenance hooks are paid
#: while the engine is attached regardless, so skipping small floods
#: only ADDS relative overhead (measured: 0.78x at 12 vs 1.11x at 0 on
#: the 1000-worker sim).  The knob exists for experiments that want the
#: bridge inert outside the batch plane.
MIN_FLOOD_DEFAULT = 0

_i32 = ctypes.c_int32
_i64 = ctypes.c_int64
_u8 = ctypes.c_uint8
_f64 = ctypes.c_double


def _arr(ctype, values):
    return (ctype * len(values))(*values)


class _Buf:
    """Growable persistent ctypes buffer filled by slice assignment."""

    __slots__ = ("ctype", "cap", "arr")

    def __init__(self, ctype, cap=1024):
        self.ctype = ctype
        self.cap = cap
        self.arr = (ctype * cap)()

    def fill(self, values):
        n = len(values)
        if n > self.cap:
            cap = self.cap
            while cap < n:
                cap *= 2
            self.cap = cap
            self.arr = (self.ctype * cap)()
        self.arr[:n] = values
        return self.arr


class _LazyMsgs(dict):
    """Per-destination message dict returned by the deferred drives.

    Deferred native segments hold a reference to this dict and append
    their message rows only at ``sync()`` — so every READ materializes
    pending segments first, keeping per-destination message order
    identical to the oracle's.  The writer path (``setdefault``) stays
    non-syncing on purpose: the appliers and the post-sync oracle
    escape paths write through it, and a sync from inside the applier
    would recurse.
    """

    __slots__ = ("_eng",)

    def __init__(self, eng):
        super().__init__()
        self._eng = eng

    def _sync(self):
        eng = self._eng
        if eng._pending:
            eng.sync()

    def __iter__(self):
        self._sync()
        return dict.__iter__(self)

    def __len__(self):
        self._sync()
        return dict.__len__(self)

    def __contains__(self, k):
        self._sync()
        return dict.__contains__(self, k)

    def __getitem__(self, k):
        self._sync()
        return dict.__getitem__(self, k)

    def __eq__(self, other):
        self._sync()
        return dict.__eq__(self, other)

    def __ne__(self, other):
        self._sync()
        return dict.__ne__(self, other)

    __hash__ = None

    def __repr__(self):
        self._sync()
        return dict.__repr__(self)

    def get(self, k, default=None):
        self._sync()
        return dict.get(self, k, default)

    def keys(self):
        self._sync()
        return dict.keys(self)

    def values(self):
        self._sync()
        return dict.values(self)

    def items(self):
        self._sync()
        return dict.items(self)

    def copy(self):
        self._sync()
        return dict(self)

    def pop(self, *a):
        self._sync()
        return dict.pop(self, *a)

    def popitem(self):
        self._sync()
        return dict.popitem(self)


class NativeEngine:
    """Per-SchedulerState bridge to one C++ engine instance."""

    def __init__(self, state: "SchedulerState", lib: ctypes.CDLL):
        self.state = state
        self.lib = lib
        self.h = ctypes.c_void_p(lib.eng_new())
        self.ok = True
        # DTPU_NATIVE_CHECK: per-flood SoA<->python audit (dual-run
        # parity gate; the property tests do full oracle dual-state
        # parity on top of this)
        self.check = os.environ.get("DTPU_NATIVE_CHECK", "") not in ("", "0")
        # row/slot registries.  Rows park on the objects (ts.nrow /
        # ws.nidx) so the hot path pays no dict hash.
        self._rows: list[Any] = []
        self._row_free: list[int] = []
        self._wslots: list[Any] = []
        self._prefix_ids: dict[str, int] = {}
        self._group_ids: dict[str, int] = {}
        # dirty sets (python-side mutations pending resync)
        # insertion-ordered: flush visit order assigns first-sight
        # prefix/group ids and fills the SoA relation vectors, so it
        # must not be hash-seed order
        self._dirty: OrderedSet = OrderedSet()
        self._dirty_workers: OrderedSet = OrderedSet()
        # row indices allocated but never yet flushed into the SoA:
        # lets the census walk compare python rows against the C++
        # live count without forcing a flush (fresh ⊆ dirty always)
        self._fresh: set = set()
        # the applier replays native mutations through the real helpers
        # (add_replica & co) for their mirror marks — the native dirty
        # hooks must NOT re-dirty rows the engine itself just wrote
        self._applying = False
        # lifetime counters (python-side halves; native halves live in
        # the engine): oracle_transitions counts transitions executed by
        # escapes/fallbacks while the engine was attached
        self.oracle_transitions = 0
        self.floods = 0
        self.segments = 0
        from distributed_tpu_torch import config as _config

        self.min_flood = int(
            _config.get("scheduler.native-engine.min-flood")
        )
        # deferred materialization: completed native segments stash
        # (tape, n, events, round_stim, stim, now, cmsgs, wmsgs) here
        # instead of replaying immediately; sync() replays in order.
        # Invariant: self is in state._NATIVE_PENDING iff _pending is
        # non-empty (outside an in-flight sync).
        self._pending: list = []
        self._syncing = False
        # tape buffers come from a free-list pool so a deferred tape is
        # never overwritten by the next segment's native call
        self._tape_pool: list = [self._alloc_tape(1 << 14)]
        # hydration counters (dtpu_engine_hydration* metric families):
        # tape rows materialized by deferred replay, and sync() probes
        # that found everything already materialized
        self.hydrations = 0
        self.hyd_cache_hits = 0
        # persistent flush/prep buffers (ctypes array CONSTRUCTION is
        # ~2us each; 19 fresh arrays per flood was the dominant fixed
        # cost — slice-assignment into persistent buffers is a C loop).
        # Event buffers live in their own dict: flush() keys its lazy
        # init on its OWN dict being empty (sharing one dict let a
        # flood seed it first and flush raise KeyError)
        self._bufs: dict = {}
        self._ev_bufs: dict = {}
        # scratch for touched-worker write-back
        self._tw_cap = 1024
        self._tw_slots = (_i32 * self._tw_cap)()
        self._tw_occ = (_f64 * self._tw_cap)()
        # scratch for pending-rec handoff
        self._pr_cap = 4096
        self._pr_rows = (_i32 * self._pr_cap)()
        self._pr_tgts = (_i32 * self._pr_cap)()
        self._scratch8 = (_i64 * 8)()

    # ------------------------------------------------------------ attach

    @classmethod
    def attach(cls, state: "SchedulerState", *,
               build: bool = False) -> "NativeEngine | None":
        """A bridge over the native library.  ``build=True`` compiles on
        demand and raises ``RuntimeError`` when the library cannot be
        built; the default never blocks on g++ and returns None when no
        build for the current source exists yet.
        """
        lib = native.load_engine(build=build)
        if lib is None:
            return None
        ne = cls(state, lib)
        # adopt the current world: every live task and worker
        for ws in state.workers.values():
            ne.on_add_worker(ws)
        for ts in state.tasks.values():
            ne.on_new_task(ts)
        # deferred-materialization read barriers: ledger and telemetry
        # reads must fold pending native file/join rows first
        state.ledger.barrier = ne.sync
        if getattr(state.telemetry, "barrier", None) is None:
            state.telemetry.barrier = ne.sync
        return ne

    def close(self) -> None:
        self._drop_pending()
        s = self.state
        if s.ledger.barrier == self.sync:
            s.ledger.barrier = None
        if getattr(s.telemetry, "barrier", None) == self.sync:
            s.telemetry.barrier = None
        if self.h:
            self.lib.eng_free(self.h)
            self.h = ctypes.c_void_p()
        self.ok = False

    def _drop_pending(self) -> None:
        """Forget deferred segments WITHOUT replaying (teardown/degrade
        paths only — the normal path is sync())."""
        self._pending.clear()
        try:
            _NATIVE_PENDING.remove(self)
        except ValueError:
            pass

    def detach(self) -> None:
        """Tear down fully: free the C++ engine AND clear the row/slot
        markers parked on the python objects, so a later attach_native
        starts from a clean world instead of adopting stale nrow/nidx
        ids into a fresh engine."""
        if self._pending and not self._syncing:
            try:
                self.sync()
            except Exception:
                logger.exception(
                    "deferred native segments lost at detach"
                )
                self._drop_pending()
        for ts in self._rows:
            if ts is not None:
                ts.nrow = -1
        for ws in self._wslots:
            if ws is not None:
                ws.nidx = -1
        self._rows = []
        self._row_free = []
        self._wslots = []
        self._dirty.clear()
        self._dirty_workers.clear()
        self._fresh.clear()
        self.close()

    # ----------------------------------------------------------- gating

    def active(self) -> bool:
        """May the next flood/round run natively?  (Cheap; evaluated
        per flood.)  validate / per-arm wall attribution / a transition
        counter cap / non-tape-safe plugins all force the oracle."""
        s = self.state
        if not self.ok:
            return False
        if s.validate or s.WALL_ARMS or s.transition_counter_max:
            return False
        if s.plugins:
            for p in s.plugins.values():
                if not getattr(p, "tape_safe", False):
                    return False
        return True

    # ------------------------------------------------------------- hooks
    #
    # Called from SchedulerState's mutation helpers (the delta-
    # consistency seam, same discipline as scheduler/mirror.py).
    #
    # Every hook is SYNC-FIRST under deferral (_materialize): a python
    # mutation is about to land, so pending native segments must replay
    # before it — which gives flush() its invariant that anything in
    # the dirty sets was marked while python truth was current.

    def _materialize(self) -> None:
        if self._pending and not self._syncing:
            self.sync()

    def on_new_task(self, ts: "TaskState") -> None:
        self._materialize()
        if ts.nrow < 0:
            if self._row_free:
                row = self._row_free.pop()
                self._rows[row] = ts
            else:
                row = len(self._rows)
                self._rows.append(ts)
            ts.nrow = row
            self._fresh.add(row)
        self._dirty.add(ts)

    def on_forget_task(self, ts: "TaskState") -> None:
        self._materialize()  # pending tapes reference rows by index
        row = ts.nrow
        if row < 0:
            return
        self.lib.eng_task_forget(self.h, row)
        self._rows[row] = None
        self._row_free.append(row)
        ts.nrow = -1
        self._dirty.discard(ts)
        self._fresh.discard(row)

    def mark_task(self, ts: "TaskState") -> None:
        if self._applying:
            return
        self._materialize()
        if ts.nrow >= 0:
            self._dirty.add(ts)

    def mark_transition(self, ts: "TaskState") -> None:
        """An oracle transition ran for ts: its own row plus both
        relation neighborhoods may have changed."""
        if self._applying:  # pragma: no cover - applier never transitions
            return
        self._materialize()
        d = self._dirty
        if ts.nrow >= 0:
            d.add(ts)
        for dts in ts.dependencies:
            if dts.nrow >= 0:
                d.add(dts)
        for dts in ts.dependents:
            if dts.nrow >= 0:
                d.add(dts)

    # incremental deltas — the frequent between-flood mutations come
    # through here as ONE ctypes call instead of a full-row resync
    # (safe on already-dirty rows: the authoritative resync overwrites)

    def on_replica(self, ts: "TaskState", ws: "WorkerState",
                   add: bool) -> None:
        if self._applying:
            return
        self._materialize()
        if ts.nrow < 0 or ws.nidx < 0:
            return
        if add:
            self.lib.eng_replica_add(self.h, ts.nrow, ws.nidx)
        else:
            self.lib.eng_replica_remove(self.h, ts.nrow, ws.nidx)

    def on_nbytes(self, ts: "TaskState", nbytes: int) -> None:
        if self._applying:
            return
        self._materialize()
        if ts.nrow >= 0:
            self.lib.eng_task_nbytes(self.h, ts.nrow, nbytes)

    def on_who_wants(self, ts: "TaskState") -> None:
        if self._applying:
            return
        self._materialize()
        if ts.nrow >= 0:
            self.lib.eng_task_who_wants(self.h, ts.nrow,
                                        len(ts.who_wants))

    def mark_worker(self, ws: "WorkerState") -> None:
        if self._applying:
            return
        self._materialize()
        if ws.nidx >= 0:
            self._dirty_workers.add(ws)

    def on_add_worker(self, ws: "WorkerState") -> None:
        self._materialize()
        if ws.nidx < 0:
            ws.nidx = len(self._wslots)
            self._wslots.append(ws)
            # eager upsert: every python slot has a live SoA twin from
            # registration on (the census walk-vs-counter audit on
            # native.soa-workers relies on this; adds are rare)
            self._upsert_worker(ws)
        self._dirty_workers.add(ws)

    def on_remove_worker(self, ws: "WorkerState") -> None:
        self._materialize()  # pending tapes reference wslots by index
        # slots are never reused (removals are rare; a rejoining
        # address gets a fresh WorkerState and a fresh slot)
        if ws.nidx >= 0:
            # the caller's replica/processing cleanup runs AFTER this
            # hook, and its on_replica deltas will no-op once nidx is
            # -1: mark every task referencing the dead worker dirty NOW
            # so the next flush rebuilds their who_has/processing_on
            # from python truth (the stale slot otherwise survives in
            # the SoA and trips the DTPU_NATIVE_CHECK audit as a false
            # divergence)
            for ts in ws.has_what:
                self.mark_task(ts)
            for ts in ws.processing:
                self.mark_task(ts)
            self.lib.eng_worker_close(self.h, ws.nidx)
            self._dirty_workers.discard(ws)
            self._wslots[ws.nidx] = None
            ws.nidx = -1

    def reset(self) -> None:
        """_clear_task_state: drop every task row (workers survive)."""
        self._materialize()
        self._dirty.clear()
        self._fresh.clear()
        for row, ts in enumerate(self._rows):
            if ts is not None:
                self.lib.eng_task_forget(self.h, row)
                ts.nrow = -1
        self._rows = []
        self._row_free = []

    # ------------------------------------------------------------ flush

    def _prefix_id(self, name: str) -> int:
        pid = self._prefix_ids.get(name)
        if pid is None:
            pid = self._prefix_ids[name] = len(self._prefix_ids)
        return pid

    def _group_id(self, name: str) -> int:
        gid = self._group_ids.get(name)
        if gid is None:
            gid = self._group_ids[name] = len(self._group_ids)
        return gid

    def _task_flags(self, ts: "TaskState", ws_long) -> int:
        f = 0
        if ts.actor:
            f |= F_ACTOR
        if ts.host_restrictions or ts.worker_restrictions \
                or ts.resource_restrictions:
            f |= F_RESTRICTED
        if not ts.run_spec:
            f |= F_NO_RUNSPEC
        if ts.exception_blame is not None:
            f |= F_BLAMED
        if ws_long is not None and ts in ws_long:
            f |= F_LONG_RUNNING
        return f

    def flush(self) -> None:
        """Resync every dirty row into the SoA (bulk, authoritative
        vector order) plus the prefixes/groups/workers they touch."""
        lib, h = self.lib, self.h
        if self._dirty_workers:
            for ws in self._dirty_workers:
                if ws.nidx < 0:
                    continue
                self._upsert_worker(ws)
            self._dirty_workers.clear()
        if not self._dirty:
            return
        tasks = [ts for ts in self._dirty if ts.nrow >= 0]
        self._dirty.clear()
        self._fresh.clear()
        if not tasks:
            return
        prefixes: set = set()
        groups: set = set()
        rows, state_a, flags_a, prefix_a, group_a = [], [], [], [], []
        nbytes_a, whowants_a, procon_a, occ_a = [], [], [], []
        dep_off, dep_flat, depw_flat = [0], [], []
        wtr_off, wtr_flat = [0], []
        who_off, who_flat = [0], []
        dept_off, dept_flat = [0], []
        for ts in tasks:
            rows.append(ts.nrow)
            state_a.append(STATE_IDX.get(ts.state, 0))
            pws = ts.processing_on
            flags_a.append(self._task_flags(
                ts, pws.long_running if pws is not None else None
            ))
            tp = ts.prefix
            if tp is not None:
                prefix_a.append(self._prefix_id(tp.name))
                prefixes.add(tp)
            else:
                prefix_a.append(-1)
            tg = ts.group
            if tg is not None:
                group_a.append(self._group_id(tg.name))
                groups.add(tg)
            else:
                group_a.append(-1)
            nbytes_a.append(ts.nbytes)
            whowants_a.append(len(ts.who_wants))
            procon_a.append(pws.nidx if pws is not None else -1)
            occ_a.append(
                pws.processing.get(ts, 0.0) if pws is not None else 0.0
            )
            waiting = ts.waiting_on
            for dts in ts.dependencies:
                dep_flat.append(dts.nrow)
                depw_flat.append(1 if dts in waiting else 0)
            dep_off.append(len(dep_flat))
            for dts in ts.waiters:
                wtr_flat.append(dts.nrow)
            wtr_off.append(len(wtr_flat))
            for hws in ts.who_has:
                who_flat.append(hws.nidx)
            who_off.append(len(who_flat))
            for dts in ts.dependents:
                dept_flat.append(dts.nrow)
            dept_off.append(len(dept_flat))
        for tp in prefixes:
            lib.eng_prefix_set(h, self._prefix_id(tp.name),
                               _f64(tp.duration_average))
        for tg in groups:
            dep_gids = _arr(_i32, [
                self._group_id(dg.name) for dg in tg.dependencies
            ])
            lib.eng_group_upsert(h, self._group_id(tg.name),
                                 tg.n_tasks, len(dep_gids), dep_gids)
        B = self._bufs
        if not B:
            for name, ct in (
                ("rows", _i32), ("state", _u8), ("flags", _u8),
                ("prefix", _i32), ("group", _i32), ("nbytes", _i64),
                ("whowants", _i32), ("procon", _i32), ("occ", _f64),
                ("dep_off", _i64), ("dep_flat", _i32), ("depw", _u8),
                ("wtr_off", _i64), ("wtr_flat", _i32),
                ("who_off", _i64), ("who_flat", _i32),
                ("dept_off", _i64), ("dept_flat", _i32),
            ):
                B[name] = _Buf(ct)
        lib.eng_task_sync_bulk(
            h, len(rows), B["rows"].fill(rows),
            B["state"].fill(state_a), B["flags"].fill(flags_a),
            B["prefix"].fill(prefix_a), B["group"].fill(group_a),
            B["nbytes"].fill(nbytes_a), B["whowants"].fill(whowants_a),
            B["procon"].fill(procon_a), B["occ"].fill(occ_a),
            B["dep_off"].fill(dep_off), B["dep_flat"].fill(dep_flat),
            B["depw"].fill(depw_flat),
            B["wtr_off"].fill(wtr_off), B["wtr_flat"].fill(wtr_flat),
            B["who_off"].fill(who_off), B["who_flat"].fill(who_flat),
            B["dept_off"].fill(dept_off), B["dept_flat"].fill(dept_flat),
        )

    def _upsert_worker(self, ws: "WorkerState") -> None:
        s = self.state
        self.lib.eng_worker_upsert(
            self.h, ws.nidx, WSTATUS_IDX.get(ws.status, 0), ws.nthreads,
            ws.nbytes, _f64(ws.occupancy), len(ws.processing),
            1 if ws.address in s.idle else 0,
            1 if ws in s.idle_task_count else 0,
            1 if ws in s.saturated else 0,
            ws.address.encode(),
        )

    def _params(self) -> None:
        s = self.state
        if self._pending:
            # the python-side incremental total is stale while segments
            # are deferred (its write-back runs at replay): the SoA
            # total is authoritative, read it back before pushing
            s._total_occupancy = self.lib.eng_total_occupancy(self.h)
        self.lib.eng_params(
            self.h, _f64(s.bandwidth), _f64(s.transfer_latency),
            _f64(s.UNKNOWN_TASK_DURATION), _f64(s.WORKER_SATURATION),
            _f64(s._total_occupancy), s.total_nthreads,
            len(s.workers), len(s.running),
            1 if s.placement is not None else 0,
        )

    # tape pool: a tape set is (cap, op, a, b, c, f1, f2).  Deferred
    # segments own their tape until sync() returns it to the pool, so
    # the next segment's native call can never overwrite pending rows.

    @staticmethod
    def _alloc_tape(cap: int):
        return (cap, (_i32 * cap)(), (_i32 * cap)(), (_i32 * cap)(),
                (_i32 * cap)(), (_f64 * cap)(), (_f64 * cap)())

    def _acquire_tape(self, n_events: int):
        # generous sizing keeps R_TAPE_FULL out of steady state: a
        # finished-task chain is a handful of rows plus flips
        cap = min(max(32 * n_events + 4096, 1 << 14), 1 << 22)
        pool = self._tape_pool
        if pool:
            tape = pool.pop()
            if tape[0] >= cap:
                return tape
            # too small for this flood: replace (steady-state flood
            # sizes converge, so the pool reaches zero-alloc reuse)
        return self._alloc_tape(cap)

    def _set_tape(self, tape) -> None:
        self.lib.eng_set_tape(
            self.h, tape[1], tape[2], tape[3], tape[4], tape[5],
            tape[6], tape[0],
        )

    # ------------------------------------------- deferred materialization

    def _defer_tape(self, tape, events, round_stim: str, stim: str,
                    now: float, client_msgs: dict,
                    worker_msgs: dict) -> None:
        """Park one completed native segment for later replay."""
        n = self.lib.eng_tape_len(self.h)
        self._pending.append(
            (tape, n, events, round_stim, stim, now, client_msgs,
             worker_msgs)
        )
        if len(self._pending) == 1:
            _NATIVE_PENDING.append(self)

    def sync(self) -> None:
        """Materialize python truth: replay every deferred segment in
        original order through the tape appliers.  This is the single
        hydration point — SoA-backed property reads, ledger/telemetry
        barriers, lazy message dicts and the mutation hooks all land
        here.  A probe that finds nothing pending is a hydration-cache
        hit."""
        if self._syncing:
            return
        pending = self._pending
        if not pending:
            self.hyd_cache_hits += 1
            return
        self._syncing = True
        s = self.state
        try:
            _NATIVE_PENDING.remove(self)
        except ValueError:  # pragma: no cover - invariant guard
            pass
        s.wall.push("engine.hydrate", pending[0][4])
        try:
            while pending:
                (tape, n, events, round_stim, _stim, now, cm,
                 wm) = pending.pop(0)
                self._applying = True
                try:
                    self._apply_tape_inner(
                        tape, n, events, round_stim, cm, wm, now
                    )
                finally:
                    self._applying = False
                self.hydrations += n
                self._tape_pool.append(tape)
        finally:
            # a replay exception leaves the remainder pending: restore
            # the registry invariant so reads keep forcing (and the
            # drives' degrade path can still detach cleanly)
            if pending and self not in _NATIVE_PENDING:
                _NATIVE_PENDING.append(self)
            s.wall.pop()
            self._syncing = False

    # ----------------------------------------------------- public drives

    def drive_finished_flood(
        self, finishes
    ) -> "tuple[dict, dict] | None":
        """The native twin of stimulus_tasks_finished_batch: same
        journal records, same wall phases, same histogram/trace
        observations, bit-identical outputs.  None = the flood is
        below the min-flood amortization floor and the caller must run
        the oracle."""
        s = self.state
        if not isinstance(finishes, (list, tuple)):
            finishes = list(finishes)
        if len(finishes) < self.min_flood:
            return None  # below the amortization floor: oracle flood
        # lazy message dicts: deferred segments append into these at
        # sync(), and any read of them forces the sync — callers (the
        # server's send_all, the parity tests' canonicalizers) iterate,
        # which materializes first
        client_msgs: dict = _LazyMsgs(self)
        worker_msgs: dict = _LazyMsgs(self)
        tr = s.trace
        t0 = s.clock()
        stim0 = finishes[0][2] if finishes else ""
        self.floods += 1
        s.wall.push("engine.drain", stim0)
        try:
            if tr.journal_enabled and finishes:
                # journal records are the engine's INPUTS: the same
                # single per-flood record the oracle arm writes (same
                # empty-flood guard) — streams stay bit-identical
                # across engines
                tr.record(
                    "tasks-finished-batch",
                    {"finishes": [
                        [key, worker, sid, dict(kwargs)]
                        for key, worker, sid, kwargs in finishes
                    ]},
                    stim0,
                )
            i, n = 0, len(finishes)
            while i < n:
                if s.queued or not self.active():
                    # queue-slot passes are per-event: the oracle owns
                    # the rest of the flood.  Materialize first — the
                    # oracle writes messages directly, and deferred
                    # rows must land ahead of them per destination.
                    if self._pending:
                        self.sync()
                    for j in range(i, n):
                        self._oracle_finished_event(
                            finishes[j], client_msgs, worker_msgs
                        )
                    break
                try:
                    i = self._segment_finished(
                        finishes, i, t0, client_msgs, worker_msgs
                    )
                except AssertionError:
                    raise  # DTPU_NATIVE_CHECK audit: must bite
                except Exception:
                    # a bridge bug must degrade, not wedge the
                    # scheduler: disable native and let the oracle
                    # finish the flood.  DETACH so a long-lived
                    # scheduler stops paying the SoA-maintenance hooks
                    # for a dead engine.
                    logger.exception(
                        "native segment failed; disabling native engine"
                    )
                    if s.native is self:
                        s.native = None
                    self.detach()
            if s.plugins and self._pending:
                # tape-safe plugins (stealing, sim digest, diagnostics)
                # read their own structures between floods: their hooks
                # must have run by flood end.  Deferral across floods is
                # a pluginless (batch-plane/bench) property.
                try:
                    self.sync()
                except AssertionError:
                    raise
                except Exception:
                    logger.exception(
                        "flood-end sync failed; disabling native engine"
                    )
                    if s.native is self:
                        s.native = None
                    self.detach()
        finally:
            s.wall.pop()
        if finishes:
            s.hist_engine_batch.observe(n)
            s.hist_engine_pass.observe(s.clock() - t0)
            tr.emit("engine", "task-finished-batch", stim0, n=n)
        return client_msgs, worker_msgs

    def drive_recs_round(self, recommendations: dict, stimulus_id: str,
                         client_msgs: dict, worker_msgs: dict) -> None:
        """One recommendations round (the transitions /
        transitions_batch seam) through the native drain."""
        s = self.state
        if len(recommendations) == 1:
            # common scalar rounds (forgotten cascades, released pops):
            # when the single seed rec is not a compiled arm the native
            # call would escape immediately — skip its fixed cost
            key, finish = next(iter(recommendations.items()))
            ts0 = s.tasks.get(key)
            if ts0 is None or (ts0.state, finish) not in _COMPILED_SET:
                before = s.transition_counter
                s._transitions(dict(recommendations), client_msgs,
                               worker_msgs, stimulus_id)
                self.oracle_transitions += s.transition_counter - before
                return
        now = s.clock()
        rows, tgts = [], []
        for key, finish in recommendations.items():
            ts = s.tasks.get(key)
            tgt = STATE_IDX.get(finish)
            if ts is None or ts.nrow < 0 or tgt is None:
                # unknown key: the oracle's _transition silently
                # returns for it, producing nothing — drop it here;
                # unknown target names only arise from plugins, which
                # gate native off
                continue
            rows.append(ts.nrow)
            tgts.append(tgt)
        self.flush()
        self._params()
        tape = self._acquire_tape(len(rows))
        self._set_tape(tape)
        events: list = []
        s.wall.push("engine.native", stimulus_id)
        try:
            r = self.lib.eng_drain_recs(
                self.h, len(rows), _arr(_i32, rows), _arr(_i32, tgts)
            )
        finally:
            s.wall.pop()
        self.segments += 1
        # recs rounds stay eager (defer + immediate sync): their
        # callers consume plain message dicts, and rounds are small
        self._defer_tape(tape, events, stimulus_id, stimulus_id, now,
                         client_msgs, worker_msgs)
        self.sync()
        if r != R_DONE:
            self._oracle_continue(
                stimulus_id, client_msgs, worker_msgs,
                escaped=(r == R_ESCAPE),
            )
        if self.check:
            self._audit()

    # -------------------------------------------------- segment driving

    def _segment_finished(self, finishes, i: int, now: float,
                          client_msgs: dict, worker_msgs: dict) -> int:
        s = self.state
        seg = finishes[i:i + SEG_MAX]
        m = len(seg)
        l_task, l_slot, l_nbytes, l_dur, l_flags = [], [], [], [], []
        tasks_get = s.tasks.get
        workers_get = s.workers.get
        for key, worker, sid, kwargs in seg:
            ts = tasks_get(key)
            l_task.append(ts.nrow if ts is not None else -1)
            ws = workers_get(worker)
            l_slot.append(ws.nidx if ws is not None else -1)
            nb = kwargs.get("nbytes")
            l_nbytes.append(nb if nb is not None else -1)
            flags = 0
            dur = None
            startstops = kwargs.get("startstops")
            if startstops:
                for ss in startstops:
                    try:
                        if ss.get("action") == "compute":
                            if dur is None:
                                dur = ss["stop"] - ss["start"]
                            else:
                                flags |= 2  # >1 compute entries: oracle
                    except (AttributeError, KeyError, TypeError):
                        flags |= 2  # malformed startstops: oracle
                if dur is not None:
                    flags |= 1
            l_dur.append(dur if dur is not None else 0.0)
            l_flags.append(flags)
        E = self._ev_bufs
        if not E:
            E["task"] = _Buf(_i32); E["slot"] = _Buf(_i32)
            E["nbytes"] = _Buf(_i64); E["dur"] = _Buf(_f64)
            E["flags"] = _Buf(_u8)
        ev_task = E["task"].fill(l_task)
        ev_slot = E["slot"].fill(l_slot)
        ev_nbytes = E["nbytes"].fill(l_nbytes)
        ev_dur = E["dur"].fill(l_dur)
        ev_flags = E["flags"].fill(l_flags)
        self.flush()
        self._params()
        tape = self._acquire_tape(m)
        self._set_tape(tape)
        consumed = _i64(0)
        stim0 = seg[0][2] if seg else ""
        s.wall.push("engine.native", stim0)
        try:
            r = self.lib.eng_drain_finished(
                self.h, m, ev_task, ev_slot, ev_nbytes, ev_dur, ev_flags,
                ctypes.byref(consumed),
            )
        finally:
            s.wall.pop()
        self.segments += 1
        c = consumed.value
        self._defer_tape(tape, seg, "", stim0, now, client_msgs,
                         worker_msgs)
        if r == R_DONE:
            # the steady-state fast path: the segment stays DEFERRED —
            # no python object is touched until something reads one.
            # Check mode audits python-vs-SoA, so it materializes first
            # (i.e. DTPU_NATIVE_CHECK effectively disables deferral).
            if self.check:
                self._audit()
            return i + m
        # every escape hands control to the oracle: materialize first
        # so the oracle reads and writes fully-ordered python truth
        self.sync()
        if r == R_ESCAPE and self.lib.eng_escape_row(self.h) < 0:
            # event-shape escape: event c untouched natively
            self._oracle_finished_event(seg[c], client_msgs, worker_msgs)
            if self.check:
                self._audit()
            return i + c + 1
        # mid-chain escape or tape-full: event c-1's chain finishes in
        # the oracle (pending recs + the popped transition), then the
        # per-event queue-slots pass runs exactly like the oracle arm
        sid = seg[c - 1][2] if c > 0 else ""
        self._oracle_continue(
            sid, client_msgs, worker_msgs, escaped=(r == R_ESCAPE),
        )
        if s.queued:
            recs2 = s.stimulus_queue_slots_maybe_opened(sid)
            before = s.transition_counter
            s._transitions(recs2, client_msgs, worker_msgs, sid)
            self.oracle_transitions += s.transition_counter - before
        if self.check:
            self._audit()
        return i + c

    def _oracle_continue(self, stimulus_id: str, client_msgs: dict,
                         worker_msgs: dict, *, escaped: bool) -> None:
        """Hand the pending rec-dict (and, on escape, the popped
        transition) to the real engine.  This IS the oracle: from here
        to quiescence the chain runs the exact scalar path."""
        if self._pending:
            self.sync()
        s = self.state
        lib, h = self.lib, self.h
        npend = lib.eng_pending_recs(h, self._pr_rows, self._pr_tgts,
                                     self._pr_cap)
        while npend == self._pr_cap:
            self._pr_cap *= 2
            self._pr_rows = (_i32 * self._pr_cap)()
            self._pr_tgts = (_i32 * self._pr_cap)()
            npend = lib.eng_pending_recs(h, self._pr_rows, self._pr_tgts,
                                         self._pr_cap)
        recommendations: dict = {}
        rows = self._rows
        for j in range(npend):
            ts = rows[self._pr_rows[j]]
            if ts is not None:
                recommendations[ts.key] = STATE_NAMES[self._pr_tgts[j]]
        before = s.transition_counter
        if escaped:
            row = lib.eng_escape_row(h)
            ts = rows[row] if row >= 0 else None
            if ts is not None:
                finish = STATE_NAMES[lib.eng_escape_target(h)]
                r, c, w = s._transition(ts.key, finish, stimulus_id)
                _merge(client_msgs, c)
                _merge(worker_msgs, w)
                recommendations.update(r)
        s._transitions(recommendations, client_msgs, worker_msgs,
                       stimulus_id)
        self.oracle_transitions += s.transition_counter - before

    def _oracle_finished_event(self, event, client_msgs: dict,
                               worker_msgs: dict) -> None:
        """One whole task-finished event through the oracle — the exact
        per-event body of the batched arm (journal already written)."""
        if self._pending:
            self.sync()
        s = self.state
        key, worker, stimulus_id, kwargs = event
        before = s.transition_counter
        try:
            ts = s.tasks.get(key)
            if ts is None or ts.state in ("released", "forgotten", "erred"):
                worker_msgs.setdefault(worker, []).append({
                    "op": "free-keys",
                    "keys": [key],
                    "stimulus_id": stimulus_id,
                })
                return
            if ts.state == "memory":
                ws = s.workers.get(worker)
                if ws is not None and ws not in ts.who_has:
                    s.add_replica(ts, ws)
                return
            if ts.state != "processing":
                return
            ts.metadata = kwargs.pop("metadata", None) or ts.metadata
            recs, cmsgs, wmsgs = s._transition(
                key, "memory", stimulus_id, worker=worker, **kwargs
            )
            _merge(client_msgs, cmsgs)
            _merge(worker_msgs, wmsgs)
            s._transitions(recs, client_msgs, worker_msgs, stimulus_id)
            if s.queued:
                recs2 = s.stimulus_queue_slots_maybe_opened(stimulus_id)
                s._transitions(recs2, client_msgs, worker_msgs,
                               stimulus_id)
        except Exception:
            logger.exception(
                "batched task-finished event failed (%s from %s, "
                "stimulus %s)", key, worker, stimulus_id,
            )
        finally:
            self.oracle_transitions += s.transition_counter - before

    # ------------------------------------------------------ the applier

    def _apply_tape_inner(self, tape, n: int, events, round_stim: str,
                          client_msgs: dict, worker_msgs: dict,
                          now: float) -> None:
        """Replay one tape onto python truth (always via sync()).
        Mutation ORDER mirrors the oracle arms statement for statement;
        decisions and floats come from the tape.  ``now`` is the
        drive-hoisted clock stamp (ledger digests fold it verbatim, so
        a deferred replay must stamp what the eager path would have)."""
        s = self.state
        lib, h = self.lib, self.h
        if n:
            t_op = tape[1][:n]
            t_a = tape[2][:n]
            t_b = tape[3][:n]
            t_c = tape[4][:n]
            t_f1 = tape[5][:n]
            t_f2 = tape[6][:n]
            rows = self._rows
            wslots = self._wslots
            tr = s.trace
            tr_enabled = tr.enabled
            plugins = list(s.plugins.values()) if s.plugins else None
            dtrack = s.durability
            led = s.ledger
            led_on = led.enabled
            log = s._transition_log.append
            shadow_on = s.telemetry.enabled
            unknown = s.unknown_durations
            cur_stim = round_stim
            idle, idle_tc, saturated = s.idle, s.idle_task_count, s.saturated
            for j in range(n):
                op = t_op[j]
                if op == OP_WP:
                    ts = rows[t_a[j]]
                    ws = wslots[t_b[j]]
                    duration = t_f1[j]
                    comm = t_f2[j]
                    key = ts.key
                    if t_c[j] & 1:
                        unknown.setdefault(ts.prefix.name, set()).add(ts)
                    if shadow_on:
                        s.shadow_comm_cost(ts, ws, comm, "placement",
                                           cur_stim)
                    if led_on:
                        if ts.dependencies or ts.homed:
                            s.ledger_file_decision(
                                ts, ws, cur_stim, None, duration, comm,
                                now=now,
                            )
                        else:
                            prefix = ts.prefix
                            ts.ledger_row = led.file(
                                "placement", key,
                                prefix.name if prefix is not None else "",
                                ws.address, cur_stim, comm, comm, False,
                                0, 0, duration, "", "",
                                supersede=ts.ledger_row, now=now,
                            )
                    # graft-lint: allow[mirror-parity] every touched worker is mirror-marked in the segment write-back below
                    ws.processing[ts] = duration + comm
                    ts.processing_on = ws
                    ts.state = "processing"
                    if ts.actor:  # pragma: no cover - actor escapes
                        ws.actors.add(ts)
                    s._count_transition(ts, "waiting", "processing")
                    worker_msgs.setdefault(ws.address, []).append({
                        "op": "compute-task",
                        "key": key,
                        "priority": ts.priority,
                        "stimulus_id": cur_stim,
                        "who_has": {
                            dts.key: [w.address for w in dts.who_has]
                            for dts in ts.dependencies
                        },
                        "nbytes": {
                            dts.key: dts.nbytes for dts in ts.dependencies
                        },
                        "run_spec": wrap_opaque(ts.run_spec),
                        "duration": duration,
                        "resource_restrictions": ts.resource_restrictions,
                        "actor": ts.actor,
                        "annotations": ts.annotations or {},
                        "span_id": ts.group.span_id if ts.group else None,
                    })
                    s.transition_counter += 1
                    log((key, "waiting", "processing", {}, cur_stim,
                         now))
                    if tr_enabled:
                        t = tr._tick + 1
                        tr._tick = t
                        if not t % tr.sample:
                            tr.emit("transition", "processing", cur_stim,
                                    key=key, dest="waiting")
                    if plugins:
                        for plugin in plugins:
                            try:
                                plugin.transition(
                                    key, "waiting", "processing",
                                    stimulus_id=cur_stim,
                                )
                            except Exception:
                                logger.exception(
                                    "Plugin %r failed in transition",
                                    plugin,
                                )
                    if dtrack is not None:
                        # the worker's processing mirror mutated inline
                        # above (not through a marking helper): its
                        # order lists must ride the next delta snapshot
                        dtrack.mark_transition(ts)
                        dtrack.mark_worker(ws)
                elif op == OP_PM:
                    ts = rows[t_a[j]]
                    ws = wslots[t_b[j]]
                    key, worker, cur_stim, kwargs = events[t_c[j]]
                    ts.metadata = kwargs.pop("metadata", None) or ts.metadata
                    nbytes = kwargs.get("nbytes")
                    typename = kwargs.get("typename")
                    startstops = kwargs.get("startstops")
                    recs: dict = {}
                    realized = 0.0
                    if startstops:
                        prefix = ts.prefix
                        group = ts.group
                        for ss in startstops:
                            if ss.get("action") == "compute":
                                d = ss["stop"] - ss["start"]
                                realized += d
                                prefix.add_duration(d)
                                s.unknown_durations.pop(prefix.name, None)
                                group.duration += d
                                if not group.start:
                                    group.start = ss["start"]
                                group.stop = max(group.stop, ss["stop"])
                    lrow = ts.ledger_row
                    if lrow >= 0:
                        ts.ledger_row = -1
                        led.join_row(lrow, "memory", worker, now,
                                     realized, s.telemetry)
                    # _exit_processing_common (occupancy floats come
                    # from the native write-back at segment end)
                    ts.processing_on = None
                    ts.homed = False
                    # graft-lint: allow[mirror-parity] touched write-back marks the mirror row
                    ws.processing.pop(ts, None)
                    ws.long_running.discard(ts)
                    ws.executing.pop(ts, None)
                    if ts.resource_restrictions:
                        for rname, quantity in \
                                ts.resource_restrictions.items():
                            if rname in ws.used_resources:
                                ws.used_resources[rname] -= quantity
                    if nbytes is not None:
                        s.update_nbytes(ts, nbytes)
                    # inline add_replica (the native arm already proved
                    # ws not in who_has; mirror mark rides the touched
                    # write-back below, native marks are suppressed)
                    # graft-lint: allow[mirror-parity] touched write-back marks the mirror row
                    ws.nbytes += ts.get_nbytes()
                    # graft-lint: allow[mirror-parity] touched write-back marks the mirror row
                    ws.has_what[ts] = None
                    ts.who_has.add(ws)
                    if len(ts.who_has) == 2:
                        s.replicated_tasks.add(ts)
                    ts.state = "memory"
                    ts.type = typename
                    group = ts.group
                    if typename and group is not None:
                        group.types.add(typename)
                    if group is not None:
                        gs = group.states
                        gs["processing"] -= 1
                        gs["memory"] += 1
                    prefix = ts.prefix
                    if prefix is not None:
                        prefix.state_counts["memory"] += 1
                    for dts in list(ts.dependents):
                        if ts in dts.waiting_on:
                            dts.waiting_on.discard(ts)
                            if not dts.waiting_on and dts.state == "waiting":
                                recs[dts.key] = "processing"
                    for dts in ts.dependencies:
                        dts.waiters.discard(ts)
                        if not dts.waiters and not dts.who_wants:
                            recs[dts.key] = "released"
                    if not ts.waiters and not ts.who_wants:
                        recs[key] = "released"
                    else:
                        report = {
                            "op": "key-in-memory",
                            "key": key,
                            "type": ts.type,
                        }
                        for cs in ts.who_wants:
                            client_msgs.setdefault(
                                cs.client_key, []
                            ).append(report)
                    s.transition_counter += 1
                    log((key, "processing", "memory", recs, cur_stim,
                         now))
                    if tr_enabled:
                        t = tr._tick + 1
                        tr._tick = t
                        if not t % tr.sample:
                            tr.emit("transition", "memory", cur_stim,
                                    key=key, dest="processing")
                    if plugins:
                        for plugin in plugins:
                            try:
                                plugin.transition(
                                    key, "processing", "memory",
                                    stimulus_id=cur_stim, worker=worker,
                                    **kwargs,
                                )
                            except Exception:
                                logger.exception(
                                    "Plugin %r failed in transition",
                                    plugin,
                                )
                    if dtrack is not None:
                        # has_what/processing mutated inline (the
                        # add_replica/_exit_processing twins above)
                        dtrack.mark_transition(ts)
                        dtrack.mark_worker(ws)
                elif op == OP_MR:
                    ts = rows[t_a[j]]
                    key = ts.key
                    recs = {}
                    for dts in ts.waiters:
                        st = dts.state
                        if st in ("no-worker", "processing", "queued"):
                            recs[dts.key] = "waiting"
                        elif st == "waiting":
                            dts.waiting_on.add(ts)
                    freed = [hws.address for hws in ts.who_has]
                    for hws in list(ts.who_has):
                        s.remove_replica(ts, hws)
                    for addr in freed:
                        if addr in s.workers:
                            worker_msgs.setdefault(addr, []).append({
                                "op": "free-keys",
                                "keys": [key],
                                "stimulus_id": cur_stim,
                            })
                    ts.state = "released"
                    s._count_transition(ts, "memory", "released")
                    report = {"op": "lost-data", "key": key}
                    for cs in ts.who_wants:
                        client_msgs.setdefault(cs.client_key, []).append(
                            report
                        )
                    if not ts.run_spec:
                        recs[key] = "forgotten"
                    elif not ts.exception_blame and (
                            ts.who_wants or ts.waiters):
                        recs[key] = "waiting"
                    if recs.get(key) == "waiting":
                        for dts in ts.dependencies:
                            dts.waiters.add(ts)
                    else:
                        s._deregister_waiter(ts, recs)
                    s.transition_counter += 1
                    log((key, "memory", "released", recs, cur_stim,
                         now))
                    if tr_enabled:
                        t = tr._tick + 1
                        tr._tick = t
                        if not t % tr.sample:
                            tr.emit("transition", "released", cur_stim,
                                    key=key, dest="memory")
                    if plugins:
                        for plugin in plugins:
                            try:
                                plugin.transition(
                                    key, "memory", "released",
                                    stimulus_id=cur_stim,
                                )
                            except Exception:
                                logger.exception(
                                    "Plugin %r failed in transition",
                                    plugin,
                                )
                    if dtrack is not None:
                        dtrack.mark_transition(ts)
                elif op == OP_RW:
                    ts = rows[t_a[j]]
                    key = ts.key
                    recs = {}
                    for dts in ts.dependencies:
                        if not dts.who_has:
                            ts.waiting_on.add(dts)
                            if dts.state == "released":
                                recs[dts.key] = "waiting"
                            elif dts.state == "memory":
                                recs[dts.key] = "released"
                        dts.waiters.add(ts)
                    ts.state = "waiting"
                    s._count_transition(ts, "released", "waiting")
                    if not ts.waiting_on:
                        recs[key] = "processing"
                    s.transition_counter += 1
                    log((key, "released", "waiting", recs, cur_stim,
                         now))
                    if tr_enabled:
                        t = tr._tick + 1
                        tr._tick = t
                        if not t % tr.sample:
                            tr.emit("transition", "waiting", cur_stim,
                                    key=key, dest="released")
                    if plugins:
                        for plugin in plugins:
                            try:
                                plugin.transition(
                                    key, "released", "waiting",
                                    stimulus_id=cur_stim,
                                )
                            except Exception:
                                logger.exception(
                                    "Plugin %r failed in transition",
                                    plugin,
                                )
                    if dtrack is not None:
                        dtrack.mark_transition(ts)
                elif op == OP_FLIP:
                    ws = wslots[t_a[j]]
                    which = t_b[j]
                    if which == 0:
                        if t_c[j]:
                            idle[ws.address] = ws
                        else:
                            idle.pop(ws.address, None)
                    elif which == 1:
                        if t_c[j]:
                            idle_tc.add(ws)
                        else:
                            idle_tc.discard(ws)
                    else:
                        if t_c[j]:
                            saturated.add(ws)
                        else:
                            saturated.discard(ws)
                elif op == OP_FREEKEYS_STALE:
                    key, worker, cur_stim, _kw = events[t_a[j]]
                    worker_msgs.setdefault(worker, []).append({
                        "op": "free-keys",
                        "keys": [key],
                        "stimulus_id": cur_stim,
                    })
                elif op == OP_ADD_REPLICA:
                    ts = rows[t_a[j]]
                    ws = wslots[t_b[j]]
                    cur_stim = events[t_c[j]][2]
                    s.add_replica(ts, ws)
                elif op == OP_META:
                    # misrouted completion for a still-processing task:
                    # the oracle pops metadata BEFORE the arm's worker
                    # guard answers free-keys — replay both (the
                    # reporter's unaccounted copy must drop, or it
                    # outlives the task; see
                    # _transition_processing_memory's fence)
                    ts = rows[t_a[j]]
                    key, worker, cur_stim, kwargs = events[t_c[j]]
                    ts.metadata = kwargs.pop("metadata", None) \
                        or ts.metadata
                    worker_msgs.setdefault(worker, []).append({
                        "op": "free-keys",
                        "keys": [key],
                        "stimulus_id": cur_stim,
                    })
        if n == 0:
            return  # no arms ran: nothing touched, totals unchanged
        # occupancy write-back for every touched worker (python reads
        # occupancy only AFTER this — at escapes and between floods)
        k = lib.eng_touched(h, self._tw_slots, self._tw_occ, self._tw_cap)
        while k == self._tw_cap:
            self._tw_cap *= 2
            self._tw_slots = (_i32 * self._tw_cap)()
            self._tw_occ = (_f64 * self._tw_cap)()
            k = lib.eng_touched(h, self._tw_slots, self._tw_occ,
                                self._tw_cap)
        mirror = s.mirror
        wslots = self._wslots
        for j in range(k):
            ws = wslots[self._tw_slots[j]]
            if ws is None:
                continue
            # graft-lint: allow[mirror-parity] this IS the mirror-marked write-back
            ws.occupancy = self._tw_occ[j]
            if mirror is not None:
                mirror.mark(ws)
        s._total_occupancy = lib.eng_total_occupancy(h)

    # ---------------------------------------------------------- metrics

    def counters(self) -> dict:
        """The dtpu_engine_native_* metric families (http server)."""
        lib, h = self.lib, self.h
        out = {
            "transitions": int(lib.eng_transitions(h)),
            "escapes": int(lib.eng_escapes(h)),
            "oracle_transitions": self.oracle_transitions,
            "floods": self.floods,
            "segments": self.segments,
        }
        for i, name in enumerate(ESCAPE_WHY):
            c = int(lib.eng_escape_count(h, i))
            if c:
                out[f"escape_{name}"] = c
        out["hydrations"] = self.hydrations
        out["hydration_cache_hits"] = self.hyd_cache_hits
        rows_live = sum(1 for ts in self._rows if ts is not None)
        pend = sum(p[1] for p in self._pending)
        out["hydration_cache_rows"] = (
            rows_live - pend if rows_live > pend else 0
        )
        return out

    # ------------------------------------------------------------ audit

    def _audit(self) -> None:
        """DTPU_NATIVE_CHECK: assert the SoA agrees with python truth
        for every registered task and worker — the per-flood dual-run
        parity gate (cheap relative to check mode's purpose; property
        tests run full oracle dual-state parity on top)."""
        if self._pending:
            self.sync()
        s = self.state
        lib, h = self.lib, self.h
        out = self._scratch8
        for row, ts in enumerate(self._rows):
            if ts is None or ts in self._dirty:
                continue
            lib.eng_task_read(h, row, out)
            want = (
                1, STATE_IDX.get(ts.state, -9),
                ts.processing_on.nidx if ts.processing_on is not None
                else -1,
                len(ts.waiting_on), len(ts.waiters), len(ts.who_has),
                ts.nbytes, len(ts.who_wants),
            )
            got = tuple(out[:8])
            if got != want:
                raise AssertionError(
                    f"native SoA diverged for task {ts.key!r}: "
                    f"native={got} python={want}"
                )
        occ = _f64(0.0)
        for slot, ws in enumerate(self._wslots):
            if ws is None or ws in self._dirty_workers:
                continue
            lib.eng_worker_read(h, slot, ctypes.byref(occ), out)
            want_w = (
                1, WSTATUS_IDX.get(ws.status, -9), len(ws.processing),
                ws.nbytes,
                1 if ws.address in s.idle else 0,
                1 if ws in s.idle_task_count else 0,
                1 if ws in s.saturated else 0,
            )
            got_w = tuple(out[:7])
            if got_w != want_w or occ.value != ws.occupancy:
                raise AssertionError(
                    f"native SoA diverged for worker {ws.address}: "
                    f"native={got_w}/occ={occ.value} "
                    f"python={want_w}/occ={ws.occupancy}"
                )



