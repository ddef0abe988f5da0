"""Flight-recorder core: causal stimulus tracing for the control loop.

The repo's state machines already thread a ``stimulus_id`` through every
transition (``transition_log``, ``story``) and every scheduler<->worker
message.  This module adds the missing observation layer: an always-on,
bounded, allocation-free ring of structured events stamped with those
same stimulus ids, so one id joins an inbound flood (``ingress``) to the
engine pass it folded into (``engine``/``transition``), the device-kernel
cycles it touched (``kernel``), and the envelopes it emitted
(``egress``) — across scheduler and worker roles.

Three consumers (docs/observability.md):

- ``/trace`` on every node's HTTP server: JSONL tail of the ring;
- the Chrome/Perfetto exporter
  (``python -m distributed_tpu_torch.diagnostics.flight_recorder``);
- the replayable **stimulus journal** (opt-in record mode): versioned
  JSONL records of every engine stimulus, re-feedable through
  ``transitions_batch`` offline with a bit-identical transition stream —
  the capture half of the ROADMAP item 1 simulator.

Hot-loop contract (enforced by the ``trace`` bench-smoke gate): ring
slots are preallocated lists mutated in place, ``emit`` performs no
per-event allocation, task-level events sample 1-in-N
(``scheduler.trace.sample``), and traced-on overhead on the engine flood
smoke stays under 5%.

This file is pure (no IO, no event loop, no threads): the sans-io
engines may import it, and the monotonic-time lint covers it — every
timestamp here is ``utils.misc.time`` (monotonic).
"""

from __future__ import annotations

import json
from bisect import bisect_left
from collections import deque
from typing import Any, Iterable

from distributed_tpu_torch import config
from distributed_tpu_torch.utils import time

#: bump when a field is added/renamed/retyped; every JSONL record and
#: journal record carries it as ``v`` (docs/observability.md)
TRACE_SCHEMA_VERSION = 1

#: slot layout of one ring event (kept in a flat preallocated list)
EVENT_FIELDS = ("ts", "cat", "name", "stim", "key", "n", "dest")

#: event vocabulary — the ``cat`` field (docs/observability.md)
CATEGORIES = (
    "ingress",     # a stream op entered a control plane (scheduler/worker)
    "engine",      # one batched/scalar transition-engine pass
    "transition",  # one task transition (task-level, sampled 1-in-N)
    "kernel",      # a device co-processor cycle (placement/steal/AMM/mirror)
    "egress",      # a coalesced envelope left on a batched stream
    "wstim",       # a worker state-machine stimulus (task-level, sampled)
    "shadow",      # a shadow cost-model divergence sample (task-level,
                   # sampled; telemetry.py — n = ratio in permille)
    "stall",       # the stall watchdog caught a blocked event loop
                   # (diagnostics/selfprofile.py — key = formatted
                   # traceback, name = in-progress phase, n = lag ms)
    "leak",        # the retention sentinel flagged a census family
                   # (diagnostics/census.py — name = family, n = its
                   # resident member count at flag time)
)


class FlightRecorder:
    """Bounded structured event ring + opt-in replayable stimulus journal.

    One per state machine (``SchedulerState.trace``, worker
    ``WorkerState.trace``) and per bare ``Server``; servers alias their
    state's recorder so role-level HTTP routes and the engines share one
    timeline.
    """

    def __init__(
        self,
        ring_size: int | None = None,
        enabled: bool | None = None,
        sample: int | None = None,
        journal: bool | None = None,
        journal_size: int | None = None,
    ):
        if ring_size is None:
            ring_size = int(config.get("scheduler.trace.ring-size"))
        if enabled is None:
            enabled = bool(config.get("scheduler.trace.enabled"))
        if sample is None:
            sample = int(config.get("scheduler.trace.sample")) or 1
        if journal is None:
            journal = bool(config.get("scheduler.trace.journal"))
        if journal_size is None:
            journal_size = int(config.get("scheduler.trace.journal-size"))
        size = 2
        while size < ring_size:
            size <<= 1  # pow2 so the hot path masks instead of modding
        self._mask = size - 1
        # injectable clock (ROADMAP item 1 simulator): the sim harness
        # re-points this at its VirtualClock so ring events and journal
        # records are stamped in VIRTUAL seconds — two same-seed sim
        # runs then produce byte-identical journals.  Live recorders
        # keep the monotonic utils.misc.time.
        self.clock = time
        # preallocated slots, mutated in place: the fast path allocates
        # nothing (gate: bench.py --smoke "trace" alloc check)
        self._slots: list[list] = [
            [0.0, "", "", "", "", 0, ""] for _ in range(size)
        ]
        self._i = 0          # total events ever emitted (ring head)
        self._tick = 0       # task-level sampling counter
        self.enabled = bool(enabled)
        self.sample = max(int(sample), 1)
        self.journal_enabled = bool(journal)
        self.journal: deque[dict] = deque(maxlen=max(int(journal_size), 1))
        self._journal_seq = 0  # records ever journaled (capture ordinal)
        # durable capture hook (scheduler/durability.py): called with
        # every journal record AFTER it lands in the deque.  The segment
        # writer subscribes here so a long capture stays complete on
        # disk even after the bounded deque evicts its head — the
        # eviction race ``verify_journal`` can only detect, never fix.
        self.journal_sink: Any | None = None

    # ------------------------------------------------------------ fast path

    def emit(self, cat: str, name: str, stim: str, key: str = "",
             n: int = 0, dest: str = "") -> None:
        """Record one event.  In-place slot write; no allocation."""
        if not self.enabled:
            return
        i = self._i
        slot = self._slots[i & self._mask]
        slot[0] = self.clock()
        slot[1] = cat
        slot[2] = name
        slot[3] = stim
        slot[4] = key
        slot[5] = n
        slot[6] = dest
        self._i = i + 1

    def emit_task(self, cat: str, name: str, stim: str, key: str = "",
                  n: int = 0, dest: str = "") -> None:
        """Task-level event: sampled 1-in-N (``scheduler.trace.sample``)
        so per-transition emission stays off the flood critical path at
        high sample rates while batch-level events stay exact."""
        if not self.enabled:
            return
        t = self._tick + 1
        self._tick = t
        if t % self.sample:
            return
        self.emit(cat, name, stim, key, n, dest)

    # ----------------------------------------------------- journal (record)

    def record(self, op: str, payload: dict, stim: str) -> None:
        """Append one replayable stimulus record (record mode only).

        Unlike ring events these are *inputs* to the engine — op, payload,
        stimulus id, monotonic ts — sufficient to re-drive
        ``transitions_batch`` offline (``diagnostics.flight_recorder.
        replay_stimulus_trace``) and reproduce the identical transition
        stream from the same starting state.  ``seq`` is the capture
        ordinal: the bounded deque silently evicts the OLDEST records on
        overflow, and a journal missing its head would replay cleanly
        from the wrong starting point — replay's ``verify_journal``
        refuses any capture whose seqs are not the contiguous run from 0
        (use :meth:`journal_start` to begin a fresh capture)."""
        seq = self._journal_seq
        self._journal_seq = seq + 1
        sink = self.journal_sink
        rec = {
            "v": TRACE_SCHEMA_VERSION,
            "seq": seq,
            "op": op,
            "stim": stim,
            "ts": self.clock(),
            # with a durable sink attached the digest is stamped at
            # segment-append time (stamp_digests — off the engine hot
            # path, on the writer thread in production); the deque
            # holds the SAME dict, so the in-memory record heals too
            "digest": payload_digest(payload) if sink is None else None,
            "payload": payload,
        }
        self.journal.append(rec)
        if sink is not None:
            sink(rec)

    def journal_start(self) -> None:
        """Begin a fresh replayable capture: clear the journal, reset
        the capture ordinal, enable record mode."""
        self.journal.clear()
        self._journal_seq = 0
        self.journal_enabled = True

    # ------------------------------------------------------------ slow path

    @property
    def total(self) -> int:
        """Events emitted over the recorder's lifetime."""
        return self._i

    def __len__(self) -> int:
        """Events currently resident in the ring."""
        return min(self._i, self._mask + 1)

    def tail(self, n: int | None = None) -> list[dict]:
        """Newest ``n`` (default: all resident) events as dicts, oldest
        first.  ``seq`` is the event's lifetime ordinal — gaps against a
        previous tail mean the ring wrapped in between."""
        total = self._i
        count = min(total, self._mask + 1)
        if n is not None:
            count = min(count, max(int(n), 0))
        out = []
        for j in range(total - count, total):
            s = self._slots[j & self._mask]
            out.append({
                "v": TRACE_SCHEMA_VERSION,
                "seq": j,
                "ts": s[0],
                "cat": s[1],
                "name": s[2],
                "stim": s[3],
                "key": s[4],
                "n": s[5],
                "dest": s[6],
            })
        return out

    def clear(self) -> None:
        self._i = 0
        self._tick = 0
        for slot in self._slots:
            slot[0] = 0.0
            slot[1] = slot[2] = slot[3] = slot[4] = slot[6] = ""
            slot[5] = 0

    def __repr__(self) -> str:
        return (
            f"<FlightRecorder {'on' if self.enabled else 'off'} "
            f"ring={self._mask + 1} events={self._i} "
            f"journal={len(self.journal)}>"
        )


# --------------------------------------------------------------- helpers


def to_jsonl(events: Iterable[dict]) -> str:
    """Serialize events/journal records as JSON Lines (the ``/trace``
    wire format and the on-disk trace format).  Non-JSON values (opaque
    payload frames in journaled erred events) degrade to ``repr`` —
    stated in the schema contract, docs/observability.md."""
    return "".join(
        json.dumps(ev, default=repr, separators=(",", ":")) + "\n"
        for ev in events
    )


def from_jsonl(text: str | bytes) -> list[dict]:
    if isinstance(text, bytes):
        text = text.decode()
    return [json.loads(line) for line in text.splitlines() if line.strip()]


def dump_journal(records: Iterable[dict], path: str) -> int:
    """Write a stimulus journal (or any event list) to ``path`` as JSONL.
    Returns the number of records written.  The on-disk format is the
    same schema-versioned record stream ``/trace`` serves, so a dumped
    journal replays through ``replay_stimulus_trace`` and through the
    simulator's journal trace source unchanged."""
    records = list(records)
    with open(path, "w") as f:
        f.write(to_jsonl(records))
    return len(records)


def load_journal(path: str) -> list[dict]:
    """Load a JSONL stimulus journal from disk (the counterpart of
    :func:`dump_journal`; the simulator's recorded-trace source).
    Integrity is NOT checked here — ``verify_journal`` (diagnostics.
    flight_recorder) runs digest + contiguity checks before any replay."""
    with open(path) as f:
        return from_jsonl(f.read())


def atomic_write_bytes(path: str, blob: bytes) -> int:
    """Crash-consistent file write: temp sibling, flush, ``fsync``,
    ``os.replace``, directory ``fsync``.  A reader never observes a
    half-written file — it sees the old content or the new, which is
    the property the durability snapshots (scheduler/durability.py)
    build their no-torn-snapshot contract on.  Returns bytes written."""
    import os

    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)
    return len(blob)


def append_jsonl(path: str, records: Iterable[dict], fsync: bool = True) -> int:
    """Append records to a JSONL file (journal segments), optionally
    fsync'd.  Appends are NOT atomic: a crash mid-append leaves a torn
    final line, which the durability loader treats as
    never-made-durable and drops (docs/durability.md).  Returns bytes
    appended."""
    import os

    blob = to_jsonl(records).encode()
    if not blob:
        return 0
    with open(path, "ab") as f:
        f.write(blob)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    return len(blob)


def read_file_bytes(path: str) -> bytes:
    """Read one file whole (the durability loaders' delegated IO —
    scheduler/durability.py is in the sans-io lint scope and never
    opens files itself)."""
    with open(path, "rb") as f:
        return f.read()


def stamp_digests(records: Iterable[dict]) -> None:
    """Fill missing payload digests in place.  Durable capture defers
    digest computation off the engine hot path (FlightRecorder.record
    leaves ``digest: None`` while a journal_sink is attached); the
    durability sinks stamp here immediately before serializing a
    segment — on the writer thread in the live scheduler.  Records in
    the bounded deque are the same dict objects, so stamping heals the
    in-memory journal for ``verify_journal``/dump consumers too."""
    for rec in records:
        if rec.get("digest") is None:
            rec["digest"] = payload_digest(rec["payload"])


def payload_digest(payload: Any) -> str:
    """Stable short digest of a stimulus payload (canonical JSON,
    blake2b-8): lets a replay harness verify a journal wasn't edited and
    lets two captures of the same flood be diffed cheaply."""
    import hashlib

    blob = json.dumps(
        payload, default=repr, sort_keys=True, separators=(",", ":")
    ).encode()
    return hashlib.blake2b(blob, digest_size=8).hexdigest()


class Histogram:
    """Minimal fixed-bucket histogram for the prom exposition
    (``http.server.prom_histogram_lines``): cumulative ``le`` buckets,
    sum and count — enough for p50/p99 estimation in any Prometheus UI.
    ``observe`` is hot-path-safe: one bisect + two adds."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Iterable[float]):
        self.bounds = tuple(sorted(bounds))
        # counts[i] = observations in (bounds[i-1], bounds[i]];
        # counts[-1] = observations above the last bound (+Inf bucket)
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.counts[bisect_left(self.bounds, value)] += 1
        self.sum += value
        self.count += 1

    def quantile(self, q: float) -> float:
        """Approximate quantile off the bucket boundaries (tests and
        quick looks; dashboards should use histogram_quantile)."""
        if not self.count:
            return 0.0
        target = q * self.count
        seen = 0
        for bound, c in zip(self.bounds, self.counts):
            seen += c
            if seen >= target:
                return bound
        return self.bounds[-1] if self.bounds else 0.0

    def __repr__(self) -> str:
        return f"<Histogram n={self.count} sum={self.sum:.4g}>"


# engine/egress bucket layouts shared by scheduler state + exposition:
# powers of two for sizes, ~1-3-10 decades for seconds
SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096, 16384)
SECONDS_BUCKETS = (
    1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0, 3.0,
)
