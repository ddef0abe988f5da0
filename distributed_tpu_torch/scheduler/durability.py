"""Scheduler durability: incremental snapshots + journal-tail restart.

The scheduler is the one place where total state loss is possible — the
workers keep their data and their state machines across a scheduler
bounce, but the placement/replica/interest truth lived only in
``SchedulerState``.  This module turns the replayable stimulus
journal into real durability (ROADMAP item 2):

- **Incremental snapshots** — a versioned, digest-stamped serialization
  of the scheduler's task/worker/replica truth.  A *base* snapshot
  serializes everything; a *delta* snapshot re-serializes only the rows
  the :class:`DurabilityTracker` marked dirty since the previous epoch
  (task rows are the big axis and cost O(changed); worker/client/stat
  rows are small and ride every epoch).  Snapshots are written through
  ``tracing.atomic_write_bytes`` (temp + fsync + rename + dir fsync),
  so a reader sees the old epoch or the new one, never a torn file.

- **Journal segments** — the flight recorder's bounded in-memory
  journal deque gains an append-only on-disk tail: a sink installed on
  ``FlightRecorder.journal_sink`` captures every record the moment it
  is journaled, so the capture stays complete even after the deque
  evicts its head (the eviction race ``verify_journal`` can only
  detect).  Segments rotate with snapshot epochs: segment *e* holds
  exactly the records ``[watermark_e, watermark_{e+1})``, where
  ``watermark_e`` is the journal ``seq`` at the instant snapshot *e*
  was encoded — snapshots run between stream payloads, so a watermark
  always falls on an engine-batch boundary.

- **Restore** — fold base + deltas into an effective snapshot, rebuild
  a fresh ``SchedulerState`` through the same helpers the engine uses
  (``new_task`` / ``add_worker_state`` / ``add_replica``), verify the
  rebuilt state's structural digest where the snapshot carries one,
  then replay the journal tail through the real batched engine
  (``diagnostics.flight_recorder.replay_stimulus_trace``).  The
  deterministic proof that snapshot + tail reconstructs the pre-crash
  state bit-identically is ``sim/chaos.py::scenario_scheduler_bounce``.

Integrity failures raise *typed* errors (:class:`SnapshotVersionError`,
:class:`SnapshotCorruptError`, :class:`JournalCorruptError`) instead of
replaying garbage.  The one tolerated artifact is a torn FINAL line of
the FINAL journal segment: journal appends are not atomic, so a crash
mid-append leaves exactly that, and the record was never durable —
it is dropped and counted (docs/durability.md).

This module is in the sans-io lint scope: it never opens files itself
(byte IO is delegated to the ``tracing`` helpers or an injected sink —
the simulator runs everything against :class:`MemorySink`), defines no
coroutines, and stamps every duration with the monotonic clock.

The port's copy of ``distributed_tpu/scheduler/durability.py``, line for
line but for two repairs of the restore, each of which made a bounced
run part from its unbounced twin:

- ``restore_state`` adopts the recorded idle, saturated and
  idle-task-count membership as it was recorded.  The reference rebuilds
  it from the model and keeps the recorded order only where the two sets
  agree; the live sets change only when a worker is touched, so they
  often do not, and the restored digest then fails its check;
- a snapshot records ``replicated`` (``state.replicated_tasks`` in its
  order, which the AMM's ``ReduceReplicas`` scans) and a restore adopts
  that order; the reference re-adds the replicas in task order.  The
  family is optional: a snapshot without it restores as before.
"""

from __future__ import annotations

import base64
import hashlib
import json
import logging
import os
import pickle
from typing import Any, Iterable

from distributed_tpu_torch import config
from distributed_tpu_torch.tracing import (
    append_jsonl,
    atomic_write_bytes,
    read_file_bytes,
    stamp_digests,
    to_jsonl,
)
from distributed_tpu_torch.utils import OrderedSet, time

logger = logging.getLogger("distributed_tpu_torch.durability")

#: bump when a snapshot row field is added/renamed/retyped; every
#: snapshot header carries it and the loader refuses mismatches
SNAPSHOT_SCHEMA_VERSION = 1


class DurabilityError(Exception):
    """Base for snapshot/journal integrity failures."""


class SnapshotVersionError(DurabilityError):
    """Snapshot written by an incompatible schema version."""


class SnapshotCorruptError(DurabilityError):
    """Snapshot fails its digest / structure checks."""


class JournalCorruptError(DurabilityError):
    """Journal segment fails digest / contiguity / parse checks
    anywhere but the tolerated torn final line."""


# ------------------------------------------------------------ run specs


class OpaqueSpec:
    """Placeholder for a run_spec that could not be round-tripped
    (non-picklable object): truthy so the scheduler still schedules the
    task, stable repr so journal digests survive a dump/load cycle.
    A worker can never execute one — callers that need real dispatch
    must journal picklable or frame-based specs."""

    __slots__ = ("text",)

    def __init__(self, text: str):
        self.text = text

    def __repr__(self) -> str:
        return self.text

    def __eq__(self, other: object) -> bool:
        return isinstance(other, OpaqueSpec) and other.text == self.text

    def __hash__(self) -> int:
        return hash(self.text)


def _b64(b: Any) -> str:
    return base64.b64encode(bytes(b)).decode("ascii")


def _unb64(s: str) -> bytes:
    return base64.b64decode(s.encode("ascii"))


def encode_run_spec(spec: Any) -> Any:
    """JSON-pure encoding of a run_spec (or exception payload).

    Handles the shapes the scheduler actually holds: ``None``, opaque
    ``Serialized``/``Pickled`` frame wrappers (frames copied to owned
    bytes — they may still be zero-copy views of a pooled receive
    buffer), JSON literals, and picklable objects.  Anything else
    degrades to an :class:`OpaqueSpec` repr marker — schedulable, not
    executable."""
    from distributed_tpu_torch.protocol.serialize import Pickled, Serialized

    if spec is None:
        return None
    if isinstance(spec, (str, int, float, bool)):
        return {"t": "lit", "v": spec}
    if isinstance(spec, (Serialized, Pickled)):
        return {
            "t": "frames",
            "cls": type(spec).__name__,
            "header": _b64(pickle.dumps(spec.header)),
            "frames": [_b64(f) for f in spec.frames],
        }
    try:
        return {"t": "pickle", "v": _b64(pickle.dumps(spec))}
    except Exception:
        return {"t": "opaque", "r": repr(spec)}


def decode_run_spec(obj: Any) -> Any:
    from distributed_tpu_torch.protocol.serialize import Pickled, Serialized

    if obj is None:
        return None
    t = obj.get("t") if isinstance(obj, dict) else None
    if t == "lit":
        return obj["v"]
    if t == "frames":
        cls = Serialized if obj.get("cls") != "Pickled" else Pickled
        return cls(
            pickle.loads(_unb64(obj["header"])),
            [_unb64(f) for f in obj["frames"]],
        )
    if t == "pickle":
        return pickle.loads(_unb64(obj["v"]))
    if t == "opaque":
        return OpaqueSpec(obj.get("r", "<opaque>"))
    # a raw journal payload that predates encoding (or a test literal)
    return obj


# -------------------------------------------------------- dirty tracking


class DurabilityTracker:
    """Dirty-row tracker attached as ``state.durability``.

    Out-of-engine mutation helpers (``add_replica``, ``update_nbytes``,
    worker lifecycle, client interest) call the ``mark_*`` hooks
    directly — the same seams the fleet mirror marks through.  Engine
    transitions mark through :meth:`mark_transition`, called from the
    oracle's ``_transition`` funnel and from each of the native tape
    replay's transition arms (NOT the generic plugin seam — the plugin
    dispatch machinery costs more per transition than the mark itself,
    and durability capture must stay inside the steady-state flood
    budget).  Marks are O(1) dict writes plus the transitioned task's
    relation neighborhood (a transition mutates its dependents'
    ``waiting_on``/``waiters`` rows too)."""

    def __init__(self, state: Any):
        self.state = state
        # insertion-ordered: new tasks appear in creation order, so a
        # delta's fresh rows append to the fold in creation order
        self.dirty_tasks: dict[str, None] = {}
        self.removed_tasks: dict[str, None] = {}
        self.dirty_workers: dict[str, None] = {}
        self.removed_workers: dict[str, None] = {}

    # one engine transition landed for ``ts`` (hot path: keep lean)
    def mark_transition(self, ts: Any) -> None:
        d = self.dirty_tasks
        d[ts.key] = None
        for dts in ts.dependents:
            d[dts.key] = None
        for dts in ts.dependencies:
            d[dts.key] = None

    def mark_task(self, ts: Any) -> None:
        self.dirty_tasks[ts.key] = None

    def mark_worker(self, ws: Any) -> None:
        self.dirty_workers[ws.address] = None

    def mark_replica(self, ts: Any, ws: Any) -> None:
        self.dirty_tasks[ts.key] = None
        self.dirty_workers[ws.address] = None

    def on_remove_task(self, ts: Any) -> None:
        self.dirty_tasks.pop(ts.key, None)
        self.removed_tasks[ts.key] = None

    def on_remove_worker(self, ws: Any) -> None:
        self.dirty_workers.pop(ws.address, None)
        self.removed_workers[ws.address] = None

    def drain(self) -> tuple[list[str], list[str], list[str], list[str]]:
        # deferred native segments carry their own dirty marks (the
        # replay appliers call mark_transition/mark_replica): a delta
        # snapshot taken after a purely-native flood must force replay
        # first or it would capture an empty dirty set
        ne = getattr(self.state, "native", None)
        if ne is not None and ne._pending:
            ne.sync()
        out = (
            list(self.dirty_tasks), list(self.removed_tasks),
            list(self.dirty_workers), list(self.removed_workers),
        )
        self.dirty_tasks.clear()
        self.removed_tasks.clear()
        self.dirty_workers.clear()
        self.removed_workers.clear()
        return out


# ------------------------------------------------------------ row codecs


def _enc_opaque(obj: Any) -> Any:
    """Exceptions / tracebacks: same encoding as run specs."""
    return encode_run_spec(obj)


def _task_row(state: Any, ts: Any) -> dict:
    row: dict[str, Any] = {
        "k": ts.key,
        "st": ts.state,
        "pri": list(ts.priority) if ts.priority is not None else None,
        "spec": encode_run_spec(ts.run_spec),
        "deps": [d.key for d in ts.dependencies],
        "won": [d.key for d in ts.waiting_on],
        "wtr": [d.key for d in ts.waiters],
        "wants": [cs.client_key for cs in ts.who_wants],
        "has": [ws.address for ws in ts.who_has],
        "nb": ts.nbytes,
    }
    ws = ts.processing_on
    if ws is not None:
        row["proc"] = ws.address
        row["booked"] = repr(ws.processing.get(ts, 0.0))
        if ts in ws.long_running:
            row["lrun"] = True
    if ts.type:
        row["type"] = ts.type
    if ts.exception is not None:
        row["exc"] = _enc_opaque(ts.exception)
    if ts.traceback is not None:
        row["tb"] = _enc_opaque(ts.traceback)
    if ts.exception_text:
        row["extext"] = ts.exception_text
    if ts.traceback_text:
        row["tbtext"] = ts.traceback_text
    if ts.exception_blame is not None:
        row["blame"] = ts.exception_blame.key
    if ts.erred_on:
        # insertion order, not sorted: the restored OrderedSet must
        # iterate exactly like the original (free-keys message order)
        row["erred_on"] = list(ts.erred_on)
    if ts.suspicious:
        row["susp"] = ts.suspicious
    if ts.retries:
        row["retry"] = ts.retries
    if ts.host_restrictions is not None:
        row["hostr"] = sorted(ts.host_restrictions)
    if ts.worker_restrictions is not None:
        row["workr"] = sorted(ts.worker_restrictions)
    if ts.resource_restrictions is not None:
        row["resr"] = dict(ts.resource_restrictions)
    if ts.loose_restrictions:
        row["loose"] = True
    if ts.actor:
        row["actor"] = True
    if ts.annotations is not None:
        row["ann"] = ts.annotations
    if ts.metadata is not None:
        row["meta"] = _enc_opaque(ts.metadata)
    if ts.run_id is not None:
        row["runid"] = ts.run_id
    if not ts.queueable:
        row["qable"] = False
    if ts.homed:
        row["homed"] = ts.homed if isinstance(ts.homed, str) else True
    prefix = ts.prefix
    if prefix is not None and ts in state.unknown_durations.get(prefix.name, ()):
        row["unkdur"] = True
    return row


def _worker_row(state: Any, ws: Any, with_orders: bool = True) -> dict:
    row: dict[str, Any] = {
        "a": ws.address,
        "name": ws.name if isinstance(ws.name, (str, int, float)) else str(ws.name),
        "nthreads": ws.nthreads,
        "mem": ws.memory_limit,
        "status": ws.status,
        "sseq": ws.status_seq,
        "sid": ws.server_id,
        "occ": repr(ws.occupancy),
        "nocc": ws._network_occ,
        "bw": repr(ws.bandwidth),
    }
    if ws.resources:
        row["resources"] = dict(ws.resources)
    if ws.used_resources:
        row["used"] = dict(ws.used_resources)
    if ws.extra:
        row["extra"] = _enc_opaque(dict(ws.extra))
    if with_orders:
        # insertion orders of the per-worker mirrors: who_has/processing
        # iteration order feeds victim scans and removal cascades, so
        # restore must reproduce it exactly (booked values live on the
        # task rows; these lists carry order + membership only)
        row["haso"] = [ts.key for ts in ws.has_what]
        row["proco"] = [ts.key for ts in ws.processing]
    return row


def _prefix_row(tp: Any) -> dict:
    return {
        "p": tp.name,
        "avg": repr(tp.duration_average),
        "maxexec": repr(tp.max_exec_time),
        "nb": tp.nbytes_total,
        "ndur": tp.n_durations,
        "counts": dict(tp.state_counts),
    }


def _group_row(tg: Any) -> dict:
    return {
        "g": tg.name,
        "states": dict(tg.states),
        "gdeps": sorted(g.name for g in tg.dependencies),
        "nb": tg.nbytes_total,
        "dur": repr(tg.duration),
        "types": sorted(tg.types),
        "start": repr(tg.start),
        "stop": repr(tg.stop),
        "lw": tg.last_worker.address if tg.last_worker is not None else None,
        "lwtl": tg.last_worker_tasks_left,
        "span": tg.span_id,
        "n": tg.n_tasks,
    }


def _stealing_rows(state: Any) -> dict | None:
    """In-flight steal state (the stealing extension's cross-payload
    truth): a steal-request answered after a restart must find its
    ``in_flight`` entry or the confirmed move is silently dropped."""
    steal = state.extensions.get("stealing") if state.extensions else None
    if steal is None:
        return None
    return {
        "in_flight": [
            {
                "k": key,
                "victim": info.victim.address,
                "thief": info.thief.address,
                "vd": repr(info.victim_duration),
                "td": repr(info.thief_duration),
                "stim": info.stimulus_id,
            }
            for key, info in steal.in_flight.items()
        ],
        "key_stealable": [
            # levels were computed with entry-time duration priors;
            # recomputing at restore would re-bucket tasks and diverge
            # the next balance cycle from the unbounced twin
            [key, addr, level]
            for key, (addr, level) in steal.key_stealable.items()
        ],
        "rr": steal._rr,
        "count": steal.count,
    }


def snapshot_rows(state: Any, *, full: bool,
                  tracker: DurabilityTracker | None = None) -> dict:
    """Collect the serialized rows of one snapshot.  ``full=False``
    serializes only tracker-dirty task rows (plus removals); worker /
    client / prefix / group / queue / extension rows are small and ride
    every epoch (worker order lists only when the worker is dirty)."""
    if full or tracker is None:
        task_keys = list(state.tasks)
        removed_tasks: list[str] = []
        dirty_workers = set(state.workers)
        if tracker is not None:
            tracker.drain()
    else:
        dirty, removed, dws, removed_ws = tracker.drain()
        task_keys = [k for k in dirty if k in state.tasks]
        removed_tasks = removed
        dirty_workers = set(dws)

    prefixes: dict[str, Any] = {}
    groups: dict[str, Any] = {}
    task_rows = []
    for k in task_keys:
        ts = state.tasks.get(k)
        if ts is None:
            continue
        task_rows.append(_task_row(state, ts))
        if ts.prefix is not None:
            prefixes[ts.prefix.name] = ts.prefix
        if ts.group is not None:
            groups[ts.group.name] = ts.group

    queued_order = _heap_order(state.queued)
    rows = {
        "tasks": task_rows,
        "removed_tasks": removed_tasks,
        "workers": [
            _worker_row(state, ws, with_orders=full or ws.address in dirty_workers)
            for ws in state.workers.values()
        ],
        "removed_workers": (
            [] if full or tracker is None else removed_ws
        ),
        "clients": [
            {"c": cs.client_key, "seen": repr(cs.last_seen)}
            for cs in state.clients.values()
        ],
        "prefixes": [_prefix_row(tp) for tp in prefixes.values()],
        "groups": [_group_row(tg) for tg in groups.values()],
        # queue structures in exact pop order (priority, add ordinal):
        # re-adding in this order reproduces pop order on the restored
        # heaps even across priority ties
        "queued": [ts.key for ts in queued_order],
        "parked": {
            addr: [ts.key for ts in _heap_order(heap)]
            for addr, heap in state.parked.items()
        },
        "unrunnable": [
            [ts.key, repr(since)] for ts, since in state.unrunnable.items()
        ],
        # membership sets in current iteration order: re-inserting in
        # this order reproduces scan order for same-process restores
        "idle": list(state.idle),
        "idle_task_count": [ws.address for ws in state.idle_task_count],
        "saturated": [ws.address for ws in state.saturated],
        # the AMM's ReduceReplicas scans these in this order, which is
        # the order tasks gained their second replica, not task order
        "replicated": [ts.key for ts in state.replicated_tasks],
        "scalars": {
            "transition_counter": state.transition_counter,
            "n_tasks": state.n_tasks,
            "total_occupancy": repr(state._total_occupancy),
        },
        "ext": _stealing_rows(state),
    }
    return rows


def _heap_order(heap: Any) -> list:
    """Elements of a HeapSet in exact pop order (priority, add
    ordinal) — reaches into the heap's token map, which is the only
    place the add ordinal survives."""
    return sorted(heap._data, key=lambda el: (heap.key(el), heap._token[el]))


# ---------------------------------------------------------------- digest


def state_digest(state: Any) -> str:
    """Structural digest of the scheduler truth a restore must
    reproduce: task states/relations/assignments, worker scalars and
    mirrors, queue contents and order, interest, decision-relevant
    prefix/group statistics, and the engine counters.  Diagnostics
    (transition_log, events, computations, telemetry, ledger) are
    deliberately outside the contract — docs/durability.md."""
    h = hashlib.blake2b(digest_size=16)

    def put(*parts: Any) -> None:
        h.update(("\x1e".join(repr(p) for p in parts) + "\n").encode())

    put("scalars", state.transition_counter, state.n_tasks,
        repr(state._total_occupancy), state.total_nthreads)
    for key, ts in state.tasks.items():
        ws = ts.processing_on
        put(
            "task", key, ts.state, ts.priority, ts.nbytes,
            tuple(d.key for d in ts.dependencies),
            tuple(d.key for d in ts.waiting_on),
            tuple(d.key for d in ts.waiters),
            tuple(sorted(cs.client_key for cs in ts.who_wants)),
            tuple(w.address for w in ts.who_has),
            ws.address if ws is not None else None,
            repr(ws.processing.get(ts, 0.0)) if ws is not None else "",
            ts.suspicious, ts.retries, ts.homed, ts.actor,
            ts.exception_text, ts.run_spec is not None,
        )
    for addr, ws in state.workers.items():
        put(
            "worker", addr, ws.status, ws.nthreads, ws.memory_limit,
            repr(ws.occupancy), ws.nbytes, ws._network_occ,
            tuple(ts.key for ts in ws.has_what),
            tuple(ts.key for ts in ws.processing),
            tuple(sorted(ts.key for ts in ws.long_running)),
            ws.status_seq,
        )
    put("queued", tuple(ts.key for ts in _heap_order(state.queued)))
    put("parked", tuple(
        (addr, tuple(ts.key for ts in _heap_order(heap)))
        for addr, heap in sorted(state.parked.items())
    ))
    put("unrunnable", tuple(
        (ts.key, repr(since)) for ts, since in state.unrunnable.items()
    ))
    put("idle", tuple(state.idle))
    put("running", tuple(sorted(ws.address for ws in state.running)))
    for name in sorted(state.task_prefixes):
        tp = state.task_prefixes[name]
        put("prefix", name, repr(tp.duration_average),
            repr(tp.max_exec_time), tp.nbytes_total, tp.n_durations)
    for name in sorted(state.task_groups):
        tg = state.task_groups[name]
        put("group", name, sorted(tg.states.items()), tg.nbytes_total,
            tg.last_worker.address if tg.last_worker is not None else None,
            tg.last_worker_tasks_left, tg.n_tasks)
    return h.hexdigest()


# ------------------------------------------------------------- snapshots


def encode_snapshot(rows: dict, *, epoch: int, base: bool,
                    journal_seq: int, state_dig: str | None = None) -> bytes:
    """One snapshot file: canonical JSON with a blake2b digest stamped
    over the body — the loader rejects any bit rot the atomic-rename
    write discipline didn't already prevent."""
    body = {
        "kind": "dtpu-snapshot",
        "v": SNAPSHOT_SCHEMA_VERSION,
        "epoch": int(epoch),
        "base": bool(base),
        "journal_seq": int(journal_seq),
        "state_digest": state_dig,
        "rows": rows,
    }
    blob = json.dumps(body, default=repr, sort_keys=True,
                      separators=(",", ":")).encode()
    digest = hashlib.blake2b(blob, digest_size=16).hexdigest()
    return json.dumps({"d": digest, "body": body}, default=repr,
                      separators=(",", ":")).encode()


def parse_snapshot(blob: bytes) -> dict:
    try:
        outer = json.loads(blob)
        body = outer["body"]
        want = outer["d"]
    except Exception as exc:
        raise SnapshotCorruptError(
            f"snapshot does not parse: {exc}"
        ) from exc
    check = json.dumps(body, default=repr, sort_keys=True,
                       separators=(",", ":")).encode()
    if hashlib.blake2b(check, digest_size=16).hexdigest() != want:
        raise SnapshotCorruptError(
            "snapshot fails its digest (bit rot or a hand edit); "
            "refusing to restore from it"
        )
    if body.get("kind") != "dtpu-snapshot":
        raise SnapshotCorruptError(
            f"not a durability snapshot: kind={body.get('kind')!r}"
        )
    v = body.get("v")
    if v != SNAPSHOT_SCHEMA_VERSION:
        raise SnapshotVersionError(
            f"snapshot schema v{v} != supported v{SNAPSHOT_SCHEMA_VERSION}; "
            "refusing to restore a mismatched format"
        )
    return body


def fold_snapshots(bodies: list[dict]) -> dict:
    """Fold a base snapshot + following deltas into one effective row
    set.  Updated task rows replace in place (dict order — the tasks
    dict's insertion order — is preserved); fresh rows append in their
    creation order; removals apply before the epoch's rows."""
    if not bodies:
        raise SnapshotCorruptError("no snapshot bodies to fold")
    if not bodies[0].get("base"):
        raise SnapshotCorruptError(
            f"fold must start at a base snapshot (epoch "
            f"{bodies[0].get('epoch')} is a delta)"
        )
    tasks: dict[str, dict] = {}
    workers: dict[str, dict] = {}
    out = dict(bodies[0]["rows"])
    for body in bodies:
        rows = body["rows"]
        for k in rows.get("removed_tasks", ()):
            tasks.pop(k, None)
        for row in rows.get("tasks", ()):
            tasks[row["k"]] = row
        for a in rows.get("removed_workers", ()):
            workers.pop(a, None)
        live = {row["a"] for row in rows.get("workers", ())}
        for a in list(workers):
            if a not in live:
                # worker rows ride every epoch: absence = removal
                del workers[a]
        for row in rows.get("workers", ()):
            prev = workers.get(row["a"])
            if prev is not None and "haso" not in row:
                # scalar-only row: keep the last recorded order lists
                # (no replica/processing membership change since)
                merged = dict(prev)
                merged.update(row)
                row = merged
            workers[row["a"]] = row
        # small whole-families: later epochs replace member-wise
        for fam, key in (("prefixes", "p"), ("groups", "g")):
            if rows.get(fam):
                merged_fam = {r[key]: r for r in out.get(fam, ())}
                for r in rows[fam]:
                    merged_fam[r[key]] = r
                out[fam] = list(merged_fam.values())
        for fam in ("clients", "queued", "parked", "unrunnable", "idle",
                    "idle_task_count", "saturated", "replicated", "scalars",
                    "ext"):
            if fam in rows:
                out[fam] = rows[fam]
    out["tasks"] = list(tasks.values())
    out["workers"] = list(workers.values())
    out["removed_tasks"] = []
    out["removed_workers"] = []
    return out


def _f(s: Any) -> float:
    return float(s) if not isinstance(s, float) else s


def restore_state(state: Any, rows: dict) -> None:
    """Rebuild a fresh ``SchedulerState`` from folded snapshot rows,
    through the engine's own registration helpers so the mirror /
    native SoA / ledger see a normally-built state.  ``state`` must be
    empty (fresh construction)."""
    tasks = state.tasks
    workers = state.workers

    # -- workers: registration first (tasks reference them) -----------
    for row in rows.get("workers", ()):
        ws = state.add_worker_state(
            row["a"], nthreads=int(row.get("nthreads") or 1),
            memory_limit=int(row.get("mem") or 0),
            name=row.get("name"), resources=row.get("resources") or None,
            server_id=row.get("sid"),
        )
        ws.status_seq = int(row.get("sseq") or 0)
        ws.bandwidth = _f(row.get("bw", ws.bandwidth))
        extra = decode_run_spec(row.get("extra"))
        if isinstance(extra, dict):
            ws.extra.update(extra)
        status = row.get("status", "running")
        if status != ws.status:
            state.set_worker_status(ws, status)
            if status != "running":
                state.running.discard(ws)

    # -- tasks pass 1: rows in creation order -------------------------
    for row in rows.get("tasks", ()):
        ts = state.new_task(
            row["k"], decode_run_spec(row.get("spec")), row.get("st", "released")
        )
        pri = row.get("pri")
        ts.priority = tuple(pri) if pri is not None else None
        ts.nbytes = int(row.get("nb", -1))
        ts.type = row.get("type")
        ts.exception = decode_run_spec(row.get("exc"))
        ts.traceback = decode_run_spec(row.get("tb"))
        ts.exception_text = row.get("extext", "")
        ts.traceback_text = row.get("tbtext", "")
        if row.get("erred_on"):
            ts.erred_on = OrderedSet(row["erred_on"])
        ts.suspicious = int(row.get("susp", 0))
        ts.retries = int(row.get("retry", 0))
        if row.get("hostr") is not None:
            ts.host_restrictions = set(row["hostr"])
        if row.get("workr") is not None:
            ts.worker_restrictions = set(row["workr"])
        if row.get("resr") is not None:
            ts.resource_restrictions = dict(row["resr"])
        ts.loose_restrictions = bool(row.get("loose"))
        ts.actor = bool(row.get("actor"))
        if row.get("ann") is not None:
            ts.annotations = row["ann"]
        meta = decode_run_spec(row.get("meta"))
        if meta is not None:
            ts.metadata = meta
        ts.run_id = row.get("runid")
        ts.queueable = row.get("qable", True)
        homed = row.get("homed", False)
        ts.homed = homed if isinstance(homed, str) else bool(homed)

    # -- tasks pass 2: relations / assignments / interest -------------
    for row in rows.get("tasks", ()):
        ts = tasks[row["k"]]
        for dkey in row.get("deps", ()):
            dts = tasks.get(dkey)
            if dts is not None:
                ts.add_dependency(dts)
        for dkey in row.get("won", ()):
            dts = tasks.get(dkey)
            if dts is not None:
                ts.waiting_on.add(dts)
        for dkey in row.get("wtr", ()):
            dts = tasks.get(dkey)
            if dts is not None:
                ts.waiters.add(dts)
        blame = row.get("blame")
        if blame is not None:
            ts.exception_blame = tasks.get(blame)
        for cid in row.get("wants", ()):
            cs = state.add_client_state(cid)
            ts.who_wants.add(cs)
            cs.wants_what.add(ts)
        for addr in row.get("has", ()):
            ws = workers.get(addr)
            if ws is not None:
                state.add_replica(ts, ws)
        proc = row.get("proc")
        if proc is not None:
            ws = workers.get(proc)
            if ws is not None:
                # direct rebuild of the processing mirror: the booked
                # occupancy must restore bit-exact, not be re-derived
                # from current duration priors
                booked = _f(row.get("booked", "0.0"))
                ws.processing[ts] = booked  # graft-lint: allow[mirror-parity] restore-time rebuild; the worker row is re-marked wholesale below
                ts.processing_on = ws
                if row.get("lrun"):
                    ws.long_running.add(ts)
                if ts.actor:
                    ws.actors.add(ts)
        if row.get("unkdur") and ts.prefix is not None:
            state.unknown_durations.setdefault(
                ts.prefix.name, set()
            ).add(ts)

    # -- per-worker mirror orders (booked values came from task rows) -
    for row in rows.get("workers", ()):
        ws = workers.get(row["a"])
        if ws is None:
            continue
        if "haso" in row:
            order = [tasks[k] for k in row["haso"] if k in tasks]
            if set(order) == set(ws.has_what):
                ws.has_what = dict.fromkeys(order)  # graft-lint: allow[mirror-parity] order-only rebuild at restore; marked below
        if "proco" in row:
            order = [tasks[k] for k in row["proco"] if k in tasks]
            if set(order) == set(ws.processing):
                ws.processing = {t: ws.processing[t] for t in order}  # graft-lint: allow[mirror-parity] order-only rebuild at restore; marked below
        ws.occupancy = _f(row.get("occ", "0.0"))  # graft-lint: allow[mirror-parity] exact scalar restore; marked below
        ws._network_occ = int(row.get("nocc") or 0)
        if row.get("used"):
            ws.used_resources = dict(row["used"])
        if state.mirror is not None:
            state.mirror.mark(ws)
        if state.native is not None:
            state.native.mark_worker(ws)

    # -- clients ------------------------------------------------------
    for row in rows.get("clients", ()):
        cs = state.add_client_state(row["c"])
        cs.last_seen = _f(row.get("seen", "0.0"))

    # -- queues (exact pop order) -------------------------------------
    parked_keys = {
        k: addr
        for addr, keys in (rows.get("parked") or {}).items()
        for k in keys
    }
    for k in rows.get("queued", ()):
        ts = tasks.get(k)
        if ts is None:
            continue
        state.queued.add(ts)
        if k not in parked_keys:
            state.queued_unparked.add(ts)
    for addr, keys in (rows.get("parked") or {}).items():
        ws = workers.get(addr)
        for k in keys:
            ts = tasks.get(k)
            if ts is not None and ws is not None:
                state.park_task(ts, ws)
    for k, since in rows.get("unrunnable", ()):
        ts = tasks.get(k)
        if ts is not None:
            state.unrunnable[ts] = _f(since)

    # -- prefix / group statistics (decision inputs) ------------------
    for row in rows.get("prefixes", ()):
        tp = state.task_prefixes.get(row["p"])
        if tp is None:
            tp = state.new_task_prefix(row["p"])
        tp.duration_average = _f(row.get("avg", "-1.0"))
        tp.max_exec_time = _f(row.get("maxexec", "-1.0"))
        tp.nbytes_total = int(row.get("nb") or 0)
        tp.n_durations = int(row.get("ndur") or 0)
        tp.state_counts.clear()
        tp.state_counts.update(row.get("counts") or {})
    for row in rows.get("groups", ()):
        tg = state.task_groups.get(row["g"])
        if tg is None:
            continue
        tg.states = dict(row.get("states") or tg.states)
        tg.nbytes_total = int(row.get("nb") or 0)
        tg.duration = _f(row.get("dur", "0.0"))
        tg.types = set(row.get("types") or ())
        tg.start = _f(row.get("start", "0.0"))
        tg.stop = _f(row.get("stop", "0.0"))
        lw = row.get("lw")
        tg.last_worker = workers.get(lw) if lw else None
        tg.last_worker_tasks_left = int(row.get("lwtl") or 0)
        tg.span_id = row.get("span")
        tg.n_tasks = int(row.get("n") or tg.n_tasks)
        for gname in row.get("gdeps", ()):
            dep = state.task_groups.get(gname)
            if dep is not None:
                tg.dependencies.add(dep)

    # -- scalars + membership sets ------------------------------------
    scalars = rows.get("scalars") or {}
    state.transition_counter = int(scalars.get("transition_counter") or 0)
    state.n_tasks = int(scalars.get("n_tasks") or state.n_tasks)
    state._total_occupancy = _f(scalars.get("total_occupancy", "0.0"))
    # canonical membership from the model (which also marks every
    # worker for the mirror and the native engine)...
    for ws in workers.values():
        state.check_idle_saturated(ws)
    # ...then the recorded membership, in recorded iteration order
    # (victim scans iterate these; idle is a dict and the membership
    # sets are OrderedSets, so re-inserting in recorded order reproduces
    # scan order exactly).  The live sets change only when a worker is
    # touched, so the recorded ones can differ from what the model gives
    # on the restored scalars (a worker left idle while the fleet's
    # average occupancy moved): the recorded sets are what the dead
    # state scheduled with, so a restore adopts them as they are.
    if "idle" in rows:
        state.idle = {a: workers[a] for a in rows["idle"] if a in workers}
    for fam in ("saturated", "idle_task_count"):
        if fam in rows:
            setattr(state, fam, OrderedSet(
                workers[a] for a in rows[fam] if a in workers
            ))
    # replicated tasks in recorded order: the replica rebuild above
    # re-added them in task-row order.  A snapshot without the family
    # keeps the rebuilt order.
    if "replicated" in rows:
        rec_ts = [state.tasks[k] for k in rows["replicated"] if k in state.tasks]
        if set(rec_ts) == set(state.replicated_tasks):
            state.replicated_tasks = OrderedSet(rec_ts)


def restore_stealing(steal: Any, rows: dict | None) -> None:
    """Re-seed a freshly built WorkStealing extension from snapshot
    rows: the stealable index with its entry-time levels, the in-flight
    confirm windows, and the exact occupancy overlays."""
    state = steal.state
    if rows is None:
        # no recorded extension state: seed stealable from scratch for
        # tasks already processing at the restore point
        for ts in state.tasks.values():
            if ts.state == "processing":
                steal.put_key_in_stealable(ts)
        return
    for key, addr, level in rows.get("key_stealable", ()):
        ts = state.tasks.get(key)
        levels = steal.stealable.get(addr)
        if ts is None or levels is None or ts.state != "processing":
            continue
        levels[int(level)].add(ts)
        steal.key_stealable[key] = (addr, int(level))
    for row in rows.get("in_flight", ()):
        victim = state.workers.get(row["victim"])
        thief = state.workers.get(row["thief"])
        ts = state.tasks.get(row["k"])
        if victim is None or thief is None or ts is None:
            continue
        steal.seed_in_flight(
            ts, victim, thief, _f(row["vd"]), _f(row["td"]),
            row.get("stim", ""),
        )
    steal._rr = int(rows.get("rr") or 0)
    steal.count = int(rows.get("count") or 0)


# --------------------------------------------------------------- journal


def parse_journal_segment(
    blob: bytes, *, expected_seq: int | None, final: bool,
    label: str = "journal",
) -> tuple[list[dict], int]:
    """Parse one journal segment with integrity checks: every record's
    payload digest, schema version, and seq contiguity from
    ``expected_seq``.  A torn FINAL line of the FINAL segment is the
    documented crash artifact — dropped and counted, never an error;
    everything else raises :class:`JournalCorruptError`.  Returns
    ``(records, torn_lines)``."""
    from distributed_tpu_torch.tracing import TRACE_SCHEMA_VERSION, payload_digest

    records: list[dict] = []
    torn = 0
    lines = blob.split(b"\n")
    # the torn-write allowance applies to exactly the LAST non-empty
    # line (a crash mid-append): a corrupt penultimate line must raise,
    # not be miscounted as the crash artifact with the real final
    # record silently dropped
    last_i = max(
        (i for i, ln in enumerate(lines) if ln.strip()), default=-1
    )
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        last = i == last_i
        try:
            rec = json.loads(line)
        except Exception as exc:
            if final and last:
                torn += 1
                logger.warning(
                    "%s: dropping torn final record (crash mid-append)",
                    label,
                )
                break
            raise JournalCorruptError(
                f"{label}: record at line {i} does not parse mid-segment "
                f"({exc}); refusing to replay past corruption"
            ) from exc
        v = rec.get("v")
        if v != TRACE_SCHEMA_VERSION:
            raise JournalCorruptError(
                f"{label}: record seq {rec.get('seq')} carries schema "
                f"v{v} != supported v{TRACE_SCHEMA_VERSION}"
            )
        want = rec.get("digest")
        if not want or payload_digest(rec.get("payload")) != want:
            raise JournalCorruptError(
                f"{label}: record seq {rec.get('seq')} (op "
                f"{rec.get('op')!r}) fails its payload digest"
            )
        seq = rec.get("seq")
        if expected_seq is not None and seq != expected_seq:
            raise JournalCorruptError(
                f"{label}: seq {seq} breaks contiguity (expected "
                f"{expected_seq}) — a span was evicted or lost"
            )
        if expected_seq is not None:
            expected_seq += 1
        records.append(rec)
    return records, torn


# ----------------------------------------------------------------- sinks


class MemorySink:
    """In-memory sink (the simulator's substrate, and the unit tests'):
    same byte-level semantics as :class:`FileSink`, no filesystem."""

    def __init__(self):
        self.snapshots: dict[int, bytes] = {}
        self.journals: dict[int, bytearray] = {}

    def write_snapshot(self, epoch: int, blob: bytes) -> int:
        self.snapshots[epoch] = bytes(blob)
        return len(blob)

    def append_journal(self, epoch: int, records: list[dict]) -> int:
        stamp_digests(records)
        blob = to_jsonl(records).encode()
        self.journals.setdefault(epoch, bytearray()).extend(blob)
        return len(blob)

    def read_snapshot(self, epoch: int) -> bytes:
        return self.snapshots[epoch]

    def read_journal(self, epoch: int) -> bytes:
        return bytes(self.journals.get(epoch, b""))

    def snapshot_epochs(self) -> list[int]:
        return sorted(self.snapshots)

    def journal_epochs(self) -> list[int]:
        return sorted(self.journals)


class FileSink:
    """On-disk sink: ``snap-<epoch>.json`` via fsync'd atomic rename,
    ``journal-<epoch>.jsonl`` append-only (fsync per flush).  File IO
    is delegated to the ``tracing`` helpers (this module stays in the
    sans-io lint scope)."""

    def __init__(self, directory: str, fsync_journal: bool = True):
        self.directory = directory
        self.fsync_journal = bool(fsync_journal)
        os.makedirs(directory, exist_ok=True)

    def _snap_path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"snap-{epoch:08d}.json")

    def _journal_path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"journal-{epoch:08d}.jsonl")

    def write_snapshot(self, epoch: int, blob: bytes) -> int:
        return atomic_write_bytes(self._snap_path(epoch), blob)

    def append_journal(self, epoch: int, records: list[dict]) -> int:
        stamp_digests(records)
        return append_jsonl(
            self._journal_path(epoch), records, fsync=self.fsync_journal
        )

    def read_snapshot(self, epoch: int) -> bytes:
        return read_file_bytes(self._snap_path(epoch))

    def read_journal(self, epoch: int) -> bytes:
        try:
            return read_file_bytes(self._journal_path(epoch))
        except FileNotFoundError:
            return b""

    def _epochs(self, prefix: str, suffix: str) -> list[int]:
        out = []
        for fn in os.listdir(self.directory):
            if fn.startswith(prefix) and fn.endswith(suffix):
                try:
                    out.append(int(fn[len(prefix):-len(suffix)]))
                except ValueError:
                    continue
        return sorted(out)

    def snapshot_epochs(self) -> list[int]:
        return self._epochs("snap-", ".json")

    def journal_epochs(self) -> list[int]:
        return self._epochs("journal-", ".jsonl")


# ---------------------------------------------------------------- manager


class DurabilityStats:
    """Counters exposed as ``dtpu_durability_*`` (http/server.py;
    docs/observability.md)."""

    __slots__ = (
        "snapshot_seconds", "snapshot_bytes", "snapshot_rows",
        "epochs", "base_epochs", "journal_records", "journal_bytes",
        "replay_records", "restore_seconds", "torn_records",
        "reconcile_corrections",
    )

    def __init__(self):
        self.snapshot_seconds = 0.0
        self.snapshot_bytes = 0
        self.snapshot_rows = 0
        self.epochs = 0
        self.base_epochs = 0
        self.journal_records = 0
        self.journal_bytes = 0
        self.replay_records = 0
        self.restore_seconds = 0.0
        self.torn_records = 0
        self.reconcile_corrections = 0


class DurabilityManager:
    """Owns one scheduler state's durable capture: the dirty tracker,
    the journal segment writer, and epoch bookkeeping.

    The manager is sans-io in the sense that matters: ``snapshot()``
    encodes on the caller's thread (the event loop, between payloads —
    O(changed rows)) and hands bytes to the sink; the live server runs
    the sink writes on an executor thread, the simulator's MemorySink
    is a dict store.  ``attach()`` begins capture with an epoch-0 base
    snapshot taken BEFORE journaling is enabled on the very same call —
    snapshot-then-journal is atomic with respect to the stream, so the
    segment's first record is exactly the snapshot's watermark and the
    deque's head-eviction can never open a gap."""

    def __init__(self, state: Any, sink: Any, *,
                 full_every: int | None = None,
                 state_digests: bool = False):
        self.state = state
        self.sink = sink
        self.full_every = int(
            full_every if full_every is not None
            else config.get("scheduler.durability.full-every")
        )
        self.state_digests = bool(state_digests)
        self.tracker = DurabilityTracker(state)
        self.stats = DurabilityStats()
        self.epoch = 0
        # segment records flush into the epoch of the LAST WRITTEN
        # snapshot: segment e holds exactly [watermark_e, watermark_e+1)
        self._segment = 0
        self._pending: list[dict] = []
        self._attached = False

    # ------------------------------------------------------------ capture

    def attach(self) -> dict:
        """Install tracker + journal sink and write the epoch-0 base
        snapshot.  Returns the base snapshot header info."""
        assert not self._attached
        state = self.state
        state.durability = self.tracker
        # base snapshot FIRST, journal capture armed in the same
        # synchronous call: nothing can journal between the two, so the
        # watermark contract holds from record 0
        info = self.snapshot(full=True)
        state.trace.journal_sink = self._on_record
        state.trace.journal_enabled = True
        self._attached = True
        return info

    def detach(self) -> None:
        state = self.state
        if state.trace.journal_sink is self._on_record:
            state.trace.journal_sink = None
        if state.durability is self.tracker:
            state.durability = None
        self._attached = False

    def _on_record(self, rec: dict) -> None:
        self._pending.append(rec)
        self.stats.journal_records += 1

    def flush_journal(self) -> int:
        """Append buffered records to the current epoch's segment."""
        if not self._pending:
            return 0
        records, self._pending = self._pending, []
        n = self.sink.append_journal(self._segment, records)
        self.stats.journal_bytes += n
        return n

    def snapshot(self, full: bool | None = None) -> dict:
        """Take one snapshot: flush the open segment (records below the
        watermark belong to the closing epoch), encode the rows, write
        through the sink, advance the epoch."""
        t0 = time()
        state = self.state
        epoch = self.epoch
        if full is None:
            full = epoch % max(self.full_every, 1) == 0
        self.flush_journal()
        rows = snapshot_rows(state, full=full, tracker=self.tracker)
        dig = state_digest(state) if self.state_digests else None
        blob = encode_snapshot(
            rows, epoch=epoch, base=full,
            journal_seq=state.trace._journal_seq, state_dig=dig,
        )
        nbytes = self.sink.write_snapshot(epoch, blob)
        self.epoch = epoch + 1
        self._segment = epoch
        st = self.stats
        st.snapshot_seconds += time() - t0
        st.snapshot_bytes += nbytes
        st.snapshot_rows += len(rows["tasks"])
        st.epochs += 1
        if full:
            st.base_epochs += 1
        return {
            "epoch": epoch, "base": full, "bytes": nbytes,
            "task_rows": len(rows["tasks"]),
            "journal_seq": state.trace._journal_seq,
        }

    # ------------------------------------------------------------ restore

    @staticmethod
    def load(sink: Any) -> tuple[dict, list[dict], dict]:
        """Load the latest restorable image from a sink: fold base +
        deltas, collect and verify the journal tail.  Returns
        ``(folded_rows, tail_records, info)``.  Integrity failures
        raise typed errors — a corrupt latest snapshot is never
        silently skipped."""
        epochs = sink.snapshot_epochs()
        if not epochs:
            raise SnapshotCorruptError("no snapshot in the durability sink")
        bodies = [parse_snapshot(sink.read_snapshot(e)) for e in epochs]
        base_i = max(
            i for i, b in enumerate(bodies) if b.get("base")
        )
        chain = bodies[base_i:]
        # the delta chain must be gapless: a snapshot lost to a
        # swallowed off-loop write failure (the threaded sink logs and
        # drops) would silently fold away every row dirty only in the
        # missing epoch's window — refuse loudly instead
        chain_epochs = [int(b["epoch"]) for b in chain]
        want_epochs = list(range(chain_epochs[0], chain_epochs[0] + len(chain)))
        if chain_epochs != want_epochs:
            raise SnapshotCorruptError(
                f"snapshot chain has epoch gaps: found {chain_epochs} "
                f"from base epoch {chain_epochs[0]} (a delta snapshot "
                "was lost); refusing a divergent fold"
            )
        folded = fold_snapshots(chain)
        watermark = int(chain[-1]["journal_seq"])
        latest_epoch = int(chain[-1]["epoch"])
        # journal tail: records >= watermark live in segments of the
        # latest epoch onward (the segment OPENED by the latest
        # snapshot carries its watermark as first seq)
        tail: list[dict] = []
        torn = 0
        jepochs = [e for e in sink.journal_epochs() if e >= latest_epoch]
        expected = watermark
        for j, e in enumerate(jepochs):
            blob = sink.read_journal(e)
            recs, t = parse_journal_segment(
                blob, expected_seq=expected, final=(j == len(jepochs) - 1),
                label=f"journal-{e}",
            )
            tail.extend(recs)
            torn += t
            expected = watermark + len(tail)
        info = {
            "epoch": latest_epoch,
            "base_epoch": int(chain[0]["epoch"]),
            "deltas": len(chain) - 1,
            "journal_seq": watermark,
            "tail_records": len(tail),
            "torn_records": torn,
            "state_digest": chain[-1].get("state_digest"),
        }
        return folded, tail, info

    @staticmethod
    def restore_into(state: Any, sink: Any, *,
                     verify_digest: bool = True) -> dict:
        """The whole recovery sequence against a fresh state: fold,
        rebuild, verify the structural digest (when the snapshot
        carries one), replay the journal tail through the real batched
        engine.  Replay emissions are discarded — they were already on
        the wire before the crash.  Returns restore info incl. the
        measured wall RTO of the state-rebuild phase."""
        from distributed_tpu_torch.diagnostics.flight_recorder import (
            replay_stimulus_trace,
        )

        t0 = time()
        folded, tail, info = DurabilityManager.load(sink)
        restore_state(state, folded)
        want = info.get("state_digest")
        if verify_digest and want:
            got = state_digest(state)
            if got != want:
                raise SnapshotCorruptError(
                    f"restored state digest {got} != snapshot's {want}: "
                    "the snapshot codec missed a mutation (file a bug); "
                    "refusing to continue from a divergent state"
                )
        # journaling must stay OFF during replay: the tail's records
        # must not re-journal themselves into the next capture
        assert not state.trace.journal_enabled
        replay_stimulus_trace(state, tail, verify_digests=False)
        info["restore_seconds"] = time() - t0
        return info


# ---------------------------------------------------------- reconciliation


def reconcile_worker(
    state: Any, address: str, held: Iterable, stimulus_id: str,
) -> tuple[tuple[dict, dict], dict]:
    """Cross-check a (re-)registering worker's reported data keys
    against the restored ``who_has`` — every correction routed through
    the engine, never by direct mutation.

    - a reported key whose task is ``memory`` but missing this replica
      → ``stimulus_add_keys`` (replica registration);
    - a reported key whose task is ``processing`` (the completion was
      in flight when the scheduler died) → ``stimulus_tasks_finished_
      batch`` (the engine decides — wrong-worker reports are fenced);
    - a restored replica the worker did NOT report → ``stimulus_
      release_worker_data`` (stale replica strip);
    - unknown keys are ignored (scatter data with no task row cannot be
      rebuilt without a client to want it).

    Returns ``((client_msgs, worker_msgs), counts)``."""
    ws = state.workers.get(address)
    if ws is None:
        return ({}, {}), {"unknown-worker": 1}
    held_pairs = [(k, int(nb)) for k, nb in held]
    held_keys = {k for k, _ in held_pairs}
    counts = {"added": 0, "finished": 0, "stripped": 0, "unknown": 0}
    client_msgs: dict = {}
    worker_msgs: dict = {}

    def merge(cm: dict, wm: dict) -> None:
        for dst, src in ((client_msgs, cm), (worker_msgs, wm)):
            for k, v in src.items():
                dst.setdefault(k, []).extend(v)

    add_keys: list[str] = []
    finished: list[tuple] = []
    for key, nb in held_pairs:
        ts = state.tasks.get(key)
        if ts is None:
            counts["unknown"] += 1
            continue
        if ts.state == "memory":
            if ws not in ts.who_has:
                add_keys.append(key)
                counts["added"] += 1
        elif ts.state == "processing":
            finished.append((key, address, stimulus_id, {"nbytes": nb}))
            counts["finished"] += 1
        # waiting/queued/released: the engine's stale-completion arm in
        # stimulus_tasks_finished_batch would free the surplus copy; we
        # leave those alone here — the worker keeps serving peers until
        # the normal release cascade reaches it
    if add_keys:
        merge(*state.stimulus_add_keys(add_keys, address, stimulus_id))
    if finished:
        merge(*state.stimulus_tasks_finished_batch(finished))
    for ts in [t for t in ws.has_what if t.key not in held_keys]:
        recs = state.stimulus_release_worker_data(
            ts.key, address, stimulus_id
        )
        if recs:
            merge(*state.transitions_batch([(recs, stimulus_id)]))
        counts["stripped"] += 1
    return (client_msgs, worker_msgs), counts


def worker_held_keys(worker_state: Any) -> list:
    """The ``held_keys`` registration payload a worker ships: every
    stored key with its nbytes — what the scheduler's recovery window
    reconciles ``who_has`` against."""
    out = []
    for key in worker_state.data:
        ts = worker_state.tasks.get(key)
        nb = ts.nbytes if ts is not None and ts.nbytes is not None else 0
        out.append([key, int(nb or 0)])
    return out


def snapshot_and_journal_digest_chain(sink: Any) -> list[dict]:
    """Inventory view for diagnostics/CLI: every epoch's snapshot
    size/kind/watermark (parse errors reported per epoch rather than
    raised — this is an inspection surface, not the restore path)."""
    out = []
    for e in sink.snapshot_epochs():
        try:
            body = parse_snapshot(sink.read_snapshot(e))
            out.append({
                "epoch": e, "base": body.get("base"),
                "journal_seq": body.get("journal_seq"),
                "task_rows": len(body["rows"].get("tasks", ())),
            })
        except DurabilityError as exc:
            out.append({"epoch": e, "error": str(exc)})
    return out
