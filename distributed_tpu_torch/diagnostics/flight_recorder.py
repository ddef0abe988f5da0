"""Flight-recorder tooling: Perfetto export + stimulus-trace replay.

The in-process recorder lives in ``distributed_tpu_torch.tracing`` (ring,
journal, schema).  This module is the offline half:

- ``to_perfetto(events)`` converts a ``/trace`` JSONL tail into the
  Chrome ``trace_event`` JSON format — loadable in ``chrome://tracing``
  and https://ui.perfetto.dev, one named track per event category;
- ``replay_stimulus_trace(state, records)`` re-feeds a recorded
  stimulus journal through the batched engine
  (``SchedulerState.transitions_batch`` and the ``stimulus_*_batch``
  arms) and — from the same starting state — reproduces the identical
  transition stream (key, start, finish, order; asserted by
  tests/test_observability.py and the bench-smoke ``trace`` gate).
  This is the capture half of the ROADMAP item 1 deterministic
  simulator: a recorded flood is its replay substrate;
- the CLI::

      python -m distributed_tpu_torch.diagnostics.flight_recorder \\
          --url http://127.0.0.1:8787/trace --perfetto out.json
      python -m distributed_tpu_torch.diagnostics.flight_recorder \\
          --input trace.jsonl --perfetto out.json

  reads JSONL events (live ``/trace`` endpoint, file, or stdin) and
  writes a Perfetto trace; without ``--perfetto`` it prints a per-
  category/stimulus summary.  ``--speedscope OUT`` instead interprets
  the input as ``/profile`` JSONL (diagnostics/selfprofile.py) and
  writes a https://www.speedscope.app flamegraph of the control-plane
  tree::

      python -m distributed_tpu_torch.diagnostics.flight_recorder \\
          --url http://127.0.0.1:8787/profile --speedscope prof.json

Schema contract: see docs/observability.md.  Every record carries
``v`` = ``tracing.TRACE_SCHEMA_VERSION``; the exporter refuses newer
majors rather than mis-rendering them.
"""

from __future__ import annotations

import json
import sys
from typing import Any, Iterable

from distributed_tpu_torch.tracing import (
    TRACE_SCHEMA_VERSION,
    from_jsonl,
    payload_digest,
    to_jsonl,
)

# one synthetic thread ("track") per category so Perfetto renders the
# control loop as parallel swimlanes: ingress above the engine above the
# kernels above egress, with worker stimuli at the bottom
_TRACKS = {
    "ingress": (1, "ingress (stream ops)"),
    "engine": (2, "engine (transition passes)"),
    "transition": (3, "transitions (task-level, sampled)"),
    "kernel": (4, "kernels (device co-processor)"),
    "egress": (5, "egress (coalesced envelopes)"),
    "wstim": (6, "worker stimuli"),
    "shadow": (7, "shadow cost model (divergence samples)"),
    "stall": (8, "loop stalls (watchdog captures)"),
    "leak": (12, "leaks (retention sentinel flags)"),
}
_OTHER_TRACK = (9, "other")
_LEDGER_TRACK = (10, "ledger (decision joins)")
_CP_TRACK = (11, "critical path")


def to_perfetto(events: Iterable[dict],
                telemetry: Iterable[dict] | None = None,
                ledger: Iterable[dict] | None = None,
                census: Iterable[dict] | None = None) -> dict:
    """Chrome ``trace_event`` JSON (the "JSON Array Format" with
    metadata) from flight-recorder events.  Timestamps are the ring's
    monotonic seconds scaled to microseconds — absolute values are
    meaningless across processes, deltas and ordering are exact.

    ``telemetry`` (optional) takes ``/telemetry`` JSONL records —
    snapshots of the measured-truth plane (telemetry.py), each stamped
    with the same monotonic clock — and renders them as Perfetto
    COUNTER tracks: per-link EWMA bandwidth and the prior durations
    plot on the same timeline as the stimulus events.  Sampled
    ``shadow`` ring events additionally feed a "costmodel divergence
    ratio" counter track (their ``n`` is the ratio in permille), so
    the decisions the constants are lying about are visible as spikes
    next to the engine passes that made them.

    ``census`` (optional) takes ``/census`` JSONL records
    (diagnostics/census.py) — per-family resident counts stamped with
    the same monotonic clock — and renders one ``census <family>``
    COUNTER track per family, so a family growing without bound plots
    right next to the stimulus traffic that grew it (the sentinel's
    ``leak`` ring events mark the flag instants on their own track)."""
    events = list(events)
    for ev in events:
        v = ev.get("v", TRACE_SCHEMA_VERSION)
        if v > TRACE_SCHEMA_VERSION:
            raise ValueError(
                f"trace schema v{v} is newer than this exporter "
                f"(v{TRACE_SCHEMA_VERSION}); refusing to mis-render"
            )
    trace_events: list[dict] = [
        {
            "name": "thread_name",
            "ph": "M",
            "ts": 0,
            "pid": 0,
            "tid": tid,
            "args": {"name": label},
        }
        for tid, label in (
            *_TRACKS.values(), _OTHER_TRACK, _LEDGER_TRACK, _CP_TRACK,
        )
    ]
    for ev in events:
        cat = ev.get("cat", "")
        tid, _ = _TRACKS.get(cat, _OTHER_TRACK)
        name = ev.get("name") or cat or "event"
        if cat == "transition":
            # name=finish, dest=start (see SchedulerState._transition)
            name = f"{ev.get('dest', '?')}->{name}"
        trace_events.append(
            {
                "name": name,
                "cat": cat or "event",
                "ph": "i",  # instant event
                "s": "t",   # thread-scoped instant
                "ts": float(ev.get("ts", 0.0)) * 1e6,
                "pid": 0,
                "tid": tid,
                "args": {
                    "stim": ev.get("stim", ""),
                    "key": ev.get("key", ""),
                    "n": ev.get("n", 0),
                    "dest": ev.get("dest", ""),
                    "seq": ev.get("seq"),
                },
            }
        )
        if cat == "shadow":
            # divergence counter: one sample per shadow event, value =
            # measured/constant ratio (n is permille)
            trace_events.append(
                {
                    "name": "costmodel divergence ratio",
                    "ph": "C",
                    "ts": float(ev.get("ts", 0.0)) * 1e6,
                    "pid": 0,
                    "tid": 0,
                    "args": {"ratio": float(ev.get("n", 0)) / 1000.0},
                }
            )
    for rec in telemetry or ():
        ts = float(rec.get("ts", 0.0)) * 1e6
        kind = rec.get("type")
        if kind == "link":
            trace_events.append(
                {
                    "name": (
                        f"link {rec.get('src', '?')} -> "
                        f"{rec.get('dst', '?')} MB/s"
                    ),
                    "ph": "C",
                    "ts": ts,
                    "pid": 0,
                    "tid": 0,
                    "args": {
                        "MB/s": float(rec.get("bandwidth", 0.0)) / 2**20
                    },
                }
            )
        elif kind == "prior":
            trace_events.append(
                {
                    "name": f"prior {rec.get('prefix', '?')} seconds",
                    "ph": "C",
                    "ts": ts,
                    "pid": 0,
                    "tid": 0,
                    "args": {"seconds": float(rec.get("duration", 0.0))},
                }
            )
        elif kind == "rtt":
            trace_events.append(
                {
                    "name": f"rtt {rec.get('worker', '?')} ms",
                    "ph": "C",
                    "ts": ts,
                    "pid": 0,
                    "tid": 0,
                    "args": {"ms": float(rec.get("rtt", 0.0)) * 1e3},
                }
            )
    for rec in census or ():
        if rec.get("type") != "census":
            continue
        trace_events.append(
            {
                "name": f"census {rec.get('family', '?')}",
                "ph": "C",
                "ts": float(rec.get("ts", 0.0)) * 1e6,
                "pid": 0,
                "tid": 0,
                "args": {"count": int(rec.get("count", 0))},
            }
        )
    for rec in ledger or ():
        kind = rec.get("type")
        if kind == "ledger-row":
            if not rec.get("outcome"):
                continue  # still-open rows have no join timestamp
            ts = float(rec.get("t_join", 0.0)) * 1e6
            trace_events.append(
                {
                    "name": (
                        f"{rec.get('kind', '?')}:"
                        f"{rec.get('outcome', '?')}"
                    ),
                    "cat": "ledger",
                    "ph": "i",
                    "s": "t",
                    "ts": ts,
                    "pid": 0,
                    "tid": _LEDGER_TRACK[0],
                    # stim joins the row to the decision's ingress/
                    # engine/kernel swimlanes; plan_stim to the landed
                    # plan's kernel event
                    "args": {
                        "key": rec.get("key", ""),
                        "stim": rec.get("stim", ""),
                        "plan_stim": rec.get("plan_stim", ""),
                        "worker": rec.get("worker", ""),
                        "regret_constant": rec.get("regret_constant"),
                        "regret_measured": rec.get("regret_measured"),
                    },
                }
            )
            if rec.get("outcome") in ("memory", "replicated"):
                # the regret counter track: per-join samples of both
                # models' realized-minus-predicted seconds
                trace_events.append(
                    {
                        "name": "ledger regret seconds",
                        "ph": "C",
                        "ts": ts,
                        "pid": 0,
                        "tid": 0,
                        "args": {
                            "constant": float(
                                rec.get("regret_constant") or 0.0
                            ),
                            "measured": float(
                                rec.get("regret_measured") or 0.0
                            ),
                        },
                    }
                )
        elif kind == "cp-segment":
            # the critical path as complete-duration events: one named
            # slice per phase segment, joined to the swimlanes by stim
            t0 = float(rec.get("t0", 0.0))
            t1 = float(rec.get("t1", t0))
            trace_events.append(
                {
                    "name": f"{rec.get('phase', '?')} "
                            f"{rec.get('key', '')}",
                    "cat": "critical-path",
                    "ph": "X",
                    "ts": t0 * 1e6,
                    "dur": max(t1 - t0, 0.0) * 1e6,
                    "pid": 0,
                    "tid": _CP_TRACK[0],
                    "args": {
                        "key": rec.get("key", ""),
                        "prefix": rec.get("prefix", ""),
                        "stim": rec.get("stim", ""),
                        "plan_stim": rec.get("plan_stim", ""),
                        "worker": rec.get("worker", ""),
                    },
                }
            )
    return {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        "otherData": {
            "source": "distributed_tpu_torch flight recorder",
            "schema_version": TRACE_SCHEMA_VERSION,
        },
    }


# ------------------------------------------------------------------ replay


def verify_journal(records: Iterable[dict]) -> None:
    """Raise ``ValueError`` on an edited or truncated capture.

    Two checks: every record's digest matches its payload, and the
    ``seq`` ordinals form the contiguous run from 0 — the recorder's
    bounded deque evicts its OLDEST records on overflow, and a journal
    missing its head would otherwise replay cleanly from the wrong
    starting point and present a divergent stream as faithful."""
    for i, rec in enumerate(records):
        want = rec.get("digest")
        if not want:
            # every record the recorder writes carries a digest; a
            # missing field is itself an edit and must not silently
            # downgrade to "unverified"
            raise ValueError(
                f"journal record {i} (op {rec.get('op')!r}) is missing "
                "its payload digest"
            )
        if payload_digest(rec["payload"]) != want:
            raise ValueError(
                f"journal record {i} (op {rec.get('op')!r}, stimulus "
                f"{rec.get('stim')!r}) fails its payload digest"
            )
        seq = rec.get("seq", i)
        if seq != i:
            raise ValueError(
                f"journal is not a complete capture: record {i} carries "
                f"seq {seq} (expected {i}) — the head or a middle span "
                "was evicted/edited; raise scheduler.trace.journal-size "
                "or start the capture with journal_start()"
            )


def replay_stimulus_trace(state: Any, records: Iterable[dict],
                          verify_digests: bool = True) -> tuple[dict, dict]:
    """Re-feed a recorded stimulus journal through the batched engine.

    ``state`` must be a ``SchedulerState`` in the same starting
    condition as the recording one was when its journal began (same
    tasks/workers/priorities — the journal records engine *stimuli*,
    not structural worker/task registration).  Consecutive same-op runs
    fold through the ``stimulus_*_batch`` arms exactly as
    ``rpc.core.handle_stream`` folds live floods, so the replayed
    transition stream — ``transition_log`` (key, start, finish, order)
    and the produced message multisets — is bit-identical to the
    recorded run's (the batch arms are property-tested against the
    scalar oracle).

    Returns the merged ``(client_msgs, worker_msgs)`` the replay
    produced — the simulator's egress, comparable envelope-for-envelope
    against the recorded run's.
    """
    records = list(records)
    if verify_digests:
        verify_journal(records)
    client_msgs: dict = {}
    worker_msgs: dict = {}

    def merge(cm: dict, wm: dict) -> None:
        for dst, src in ((client_msgs, cm), (worker_msgs, wm)):
            for k, v in src.items():
                dst.setdefault(k, []).extend(v)

    buf_op: str | None = None
    buf: list[tuple] = []

    def flush() -> None:
        nonlocal buf_op, buf
        if not buf:
            return
        if buf_op == "task-finished":
            merge(*state.stimulus_tasks_finished_batch(buf))
        else:
            merge(*state.stimulus_tasks_erred_batch(buf))
        buf_op, buf = None, []

    for rec in records:
        op = rec.get("op")
        payload = rec.get("payload") or {}
        if op in ("task-finished", "task-erred"):
            if buf_op is not None and buf_op != op:
                flush()
            buf_op = op
            buf.append(
                (
                    payload.get("key", ""),
                    payload.get("worker", ""),
                    rec.get("stim", ""),
                    dict(payload.get("kwargs") or {}),
                )
            )
        elif op == "tasks-finished-batch":
            # one record per engine flood (the batch arm's format —
            # per-event records cost more than the engine's own
            # per-event work on the durability capture path); replays
            # with the exact live flood boundary
            flush()
            merge(*state.stimulus_tasks_finished_batch([
                (k, w, sid, dict(kw))
                for k, w, sid, kw in payload.get("finishes") or ()
            ]))
        elif op == "release-worker-data":
            # replica removal only: the mutation happens OUTSIDE the
            # engine, and the engine round it recommended (if any) was
            # journaled as its own following "transitions" record —
            # applying the returned recs here would run it twice
            flush()
            state.stimulus_release_worker_data(
                payload.get("key", ""), payload.get("worker", ""),
                rec.get("stim", ""),
            )
        elif op == "add-keys":
            # replica registration also mutates who_has outside the
            # engine, and later placements READ it: a journal without
            # these records replays dependency graphs with drifting
            # placements (the simulator's parity test catches it)
            flush()
            merge(*state.stimulus_add_keys(
                payload.get("keys") or (), payload.get("worker", ""),
                rec.get("stim", ""),
            ))
        elif op == "long-running":
            flush()
            merge(*state.stimulus_long_running(
                payload.get("key", ""), payload.get("worker", ""),
                float(payload.get("compute_duration") or 0.0),
                rec.get("stim", ""),
            ))
        elif op == "reschedule":
            flush()
            merge(*state.stimulus_reschedule(
                payload.get("key", ""), payload.get("worker", ""),
                rec.get("stim", ""),
            ))
        elif op == "missing-data":
            flush()
            merge(*state.stimulus_missing_data(
                payload.get("key", ""), payload.get("errant_worker", ""),
                rec.get("stim", ""),
            ))
        elif op == "remove-worker":
            flush()
            merge(*state.remove_worker_state(
                payload.get("worker", ""), stimulus_id=rec.get("stim", ""),
                safe=bool(payload.get("safe", False)),
            ))
        elif op == "add-worker":
            flush()
            state.add_worker_state(
                payload.get("address", ""),
                nthreads=int(payload.get("nthreads") or 1),
                memory_limit=int(payload.get("memory_limit") or 0),
                name=payload.get("name"),
                resources=payload.get("resources") or None,
                server_id=payload.get("server_id"),
            )
        elif op == "update-graph":
            # graph intake: priorities were resolved at record time and
            # per-task dependency lists carry the original iteration
            # order, so the materialized TaskStates (relation-set
            # insertion order included) are bit-identical.  The record
            # replays its own engine round (update_graph_core runs
            # _transitions_observed), so no nested "transitions" record
            # exists for it.
            flush()
            from distributed_tpu_torch.scheduler.durability import decode_run_spec

            retries = payload.get("retries")
            actors = payload.get("actors") or False
            merge(*state.update_graph_core(
                {
                    k: decode_run_spec(v)
                    for k, v in (payload.get("tasks") or {}).items()
                },
                {
                    k: list(v)
                    for k, v in (payload.get("dependencies") or {}).items()
                },
                list(payload.get("keys") or ()),
                client=payload.get("client"),
                priorities={
                    k: tuple(v)
                    for k, v in (payload.get("priorities") or {}).items()
                },
                user_priority=payload.get("user_priority") or 0,
                generation=int(payload.get("generation") or 0),
                annotations_by_key=payload.get("annotations_by_key"),
                retries=retries,
                actors=actors,
            ))
        elif op == "client-desires-keys":
            flush()
            state.client_desires_keys(
                payload.get("keys") or (), payload.get("client", "")
            )
        elif op == "client-releases-keys":
            flush()
            merge(*state.client_releases_keys(
                payload.get("keys") or (), payload.get("client", ""),
                rec.get("stim", ""),
            ))
        elif op == "scatter-data":
            flush()
            merge(*state.stimulus_scatter_data(
                payload.get("key", ""), list(payload.get("workers") or ()),
                int(payload.get("nbytes") or 0), payload.get("client"),
                rec.get("stim", ""),
            ))
        elif op == "worker-status-change":
            flush()
            merge(*state.stimulus_worker_status_change(
                payload.get("worker", ""), payload.get("status", ""),
                int(payload.get("status_seq", -1)), rec.get("stim", ""),
            ))
        elif op == "steal-move":
            flush()
            merge(*state.stimulus_steal_move(
                payload.get("key", ""), payload.get("victim", ""),
                payload.get("thief", ""), rec.get("stim", ""),
                kind=payload.get("kind", "steal"),
            ))
        elif op == "steal-request":
            # the confirm window opened by move_task_request: rebuild
            # the stealing extension's in_flight entry (with its exact
            # priced durations and occupancy overlays) so a
            # steal-response answered after a restart finds it — the
            # restart-during-in-flight-steal case.  A state without the
            # extension (bare replay harness) skips: the entry is
            # extension truth, not engine truth.
            flush()
            steal = (state.extensions or {}).get("stealing")
            ts = state.tasks.get(payload.get("key", ""))
            victim = state.workers.get(payload.get("victim", ""))
            thief = state.workers.get(payload.get("thief", ""))
            if (steal is not None and ts is not None
                    and victim is not None and thief is not None
                    and ts.key not in steal.in_flight):
                steal.remove_key_from_stealable(ts)
                steal.seed_in_flight(
                    ts, victim, thief,
                    float(payload.get("vd") or 0.0),
                    float(payload.get("td") or 0.0),
                    rec.get("stim", ""),
                )
        elif op == "steal-rr":
            # balance-cycle round-robin cursor pin (stealing.balance)
            flush()
            steal = (state.extensions or {}).get("stealing")
            if steal is not None:
                steal._rr = int(payload.get("rr") or 0)
        elif op == "steal-confirm":
            # the close of a confirm window (move_task_confirm's pop);
            # the engine-side move — if the victim yielded — replays
            # from its own following "steal-move" record
            flush()
            steal = (state.extensions or {}).get("stealing")
            if steal is not None:
                info = steal.in_flight.pop(payload.get("key", ""), None)
                if info is not None:
                    # matched or not, a consumed window reverts its
                    # overlays — the ONE revert move_task_confirm uses
                    # (WorkStealing._revert_in_flight), so a replayed
                    # scheduler's overlay rows match the live one's
                    steal._revert_in_flight(info)
        elif op == "transitions":
            flush()
            merge(
                *state.transitions(
                    dict(payload.get("recs") or {}), rec.get("stim", "")
                )
            )
        else:
            raise ValueError(f"unknown journal op {op!r}")
    flush()
    return client_msgs, worker_msgs


def transition_stream(state: Any, since: int = 0) -> list[tuple]:
    """The comparable (key, start, finish, stimulus_id) tuples of a
    state's transition log from position ``since`` — what record/replay
    parity asserts on (timestamps excluded; they are wall-dependent).

    ``since`` is an index into the log as it stood when the capture
    began.  The log is a bounded deque: once it saturates, head rows
    are evicted and any earlier index silently points at the wrong row
    — refuse rather than compare shifted windows."""
    log = state.transition_log
    if since and log.maxlen is not None and len(log) >= log.maxlen:
        raise ValueError(
            "transition_log wrapped during the capture (maxlen="
            f"{log.maxlen}): the `since` anchor no longer addresses the "
            "capture start; raise scheduler.transition-log-length or "
            "compare shorter runs"
        )
    return [
        (row[0], row[1], row[2], row[4]) for row in list(log)[since:]
    ]


# --------------------------------------------------------------------- CLI


def _fetch_url(url: str) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read().decode()


def load_json(path: str) -> Any:
    """Read one JSON document from disk (cluster dumps, deps maps).
    Lives here rather than in the analyzers because this module owns
    the offline file IO — ``diagnostics/critical_path.py`` is in the
    sans-io lint scope and delegates all reads/writes."""
    with open(path) as f:
        return json.load(f)


def _read_jsonl_source(src: str) -> list[dict]:
    """JSONL records from a file path or an http(s) URL (the /trace,
    /telemetry and /ledger routes all serve this shape)."""
    if src.startswith(("http://", "https://")):
        return from_jsonl(_fetch_url(src))
    with open(src) as f:
        return from_jsonl(f.read())


def summarize(events: list[dict]) -> str:
    by_cat: dict[str, int] = {}
    stims: set[str] = set()
    for ev in events:
        by_cat[ev.get("cat", "?")] = by_cat.get(ev.get("cat", "?"), 0) + 1
        if ev.get("stim"):
            stims.add(ev["stim"])
    lines = [f"{len(events)} events, {len(stims)} distinct stimuli"]
    for cat, n in sorted(by_cat.items()):
        lines.append(f"  {cat:12s} {n}")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m distributed_tpu_torch.diagnostics.flight_recorder",
        description=(
            "Export a flight-recorder trace (JSONL) to the Chrome/"
            "Perfetto trace_event format, or summarize it."
        ),
    )
    parser.add_argument(
        "--input", help="trace JSONL file (default: stdin)"
    )
    parser.add_argument(
        "--url",
        help="fetch the trace from a live node's /trace route, e.g. "
             "http://127.0.0.1:8787/trace",
    )
    parser.add_argument(
        "--perfetto", metavar="OUT",
        help="write Chrome/Perfetto trace JSON to OUT "
             "(open in chrome://tracing or ui.perfetto.dev)",
    )
    parser.add_argument(
        "--telemetry", metavar="SRC",
        help="also render /telemetry JSONL records (file path or "
             "http URL) as Perfetto counter tracks: per-link measured "
             "MB/s, prior durations, heartbeat RTTs next to the "
             "stimulus timeline",
    )
    parser.add_argument(
        "--ledger", metavar="SRC",
        help="also render decision-ledger JSONL (file path or http "
             "URL: the /ledger route, a dumped tail, or critical-path "
             "records from diagnostics.critical_path --out) as a "
             "ledger-joins track, a regret counter track, and a named "
             "critical-path track joined to the stimulus swimlanes",
    )
    parser.add_argument(
        "--census", metavar="SRC",
        help="also render state-census JSONL (file path or http URL: "
             "the /census route or a dumped census section) as one "
             "counter track per container family next to the stimulus "
             "timeline (diagnostics/census.py)",
    )
    parser.add_argument(
        "--jsonl", metavar="OUT",
        help="re-emit the (possibly url-fetched) events as JSONL to OUT",
    )
    parser.add_argument(
        "--speedscope", metavar="OUT",
        help="treat the input as /profile JSONL (control-plane "
             "self-profile) and write a speedscope flamegraph to OUT",
    )
    parser.add_argument(
        "--which", default="loop",
        help="with --speedscope: which profile record to export "
             "(loop | exec; default loop)",
    )
    args = parser.parse_args(argv)

    if args.url:
        text = _fetch_url(args.url)
    elif args.input:
        with open(args.input) as f:
            text = f.read()
    else:
        text = sys.stdin.read()
    events = from_jsonl(text)
    telemetry = None
    if args.telemetry:
        telemetry = _read_jsonl_source(args.telemetry)
    ledger = None
    if args.ledger:
        ledger = _read_jsonl_source(args.ledger)
    census = None
    if args.census:
        census = _read_jsonl_source(args.census)

    wrote = False
    if args.speedscope:
        from distributed_tpu_torch.diagnostics.selfprofile import (
            profile_to_speedscope,
        )

        trees = [
            r["tree"] for r in events
            if r.get("kind") == "profile"
            and r.get("which", "loop") == args.which
        ]
        if not trees:
            print(
                f"no {args.which!r} profile record in the input "
                "(expected /profile JSONL)", file=sys.stderr,
            )
            return 1
        with open(args.speedscope, "w") as f:
            json.dump(
                profile_to_speedscope(
                    trees[0], name=f"dtpu-{args.which}-profile"
                ),
                f,
            )
        print(f"wrote speedscope profile to {args.speedscope}")
        wrote = True
    if args.perfetto:
        with open(args.perfetto, "w") as f:
            json.dump(
                to_perfetto(events, telemetry=telemetry, ledger=ledger,
                            census=census),
                f,
            )
        print(f"wrote {len(events)} events to {args.perfetto}")
        wrote = True
    if args.jsonl:
        with open(args.jsonl, "w") as f:
            f.write(to_jsonl(events))
        wrote = True
    if not wrote:
        print(summarize(events))
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    sys.exit(main())
