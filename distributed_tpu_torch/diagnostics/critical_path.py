"""Critical-path attribution: where did the makespan go?

Offline analyzer over a **decision ledger dump** (``/ledger`` JSONL,
``get_ledger`` RPC, a cluster dump's ``scheduler.ledger.rows``, or a
simulator run's ``state.ledger.tail()``) plus the completed graph's
dependency map.  It walks the critical path backwards from the
last-finishing task and attributes every second of makespan to one of
four phases, per task prefix:

- ``compute``  — worker-reported execution seconds;
- ``transfer`` — the row's telemetry-derived realized-transfer estimate
  for its dominant dep link (clamped into the observed window);
- ``queue``    — the rest of the decision→completion window (worker
  queueing + control-plane latency past the decision);
- ``scheduler``— the gap between the predecessor finishing and THIS
  task's placement decision (engine latency, parking, steal churn).

The walk telescopes exactly: segment ``k`` spans
``t_join(pred_k) .. t_join(k)``, so the phase sums add up to
``t_join(terminal) - path_start`` **by construction** — ``check()``
(and the CLI ``--check`` flag) asserts the attribution sums to the
run's makespan within tolerance, the acceptance gate the ``ledger``
bench-smoke config runs on a simulated cluster where the virtual clock
makes the identity exact.

The per-task ordering of queue vs transfer inside one decision window
is not observed (the scheduler sees the decision and the completion) —
segments render queue, then transfer, then compute, with the compute
segment anchored exactly at ``[t_join - compute, t_join]``.

Output: a summary dict (``attribution`` per phase, ``by_prefix``,
``path`` segments with absolute timestamps) and JSONL ``cp-segment`` /
``cp-summary`` records the Perfetto exporter renders as a named
critical-path track next to the stimulus swimlanes
(``python -m distributed_tpu_torch.diagnostics.flight_recorder --ledger ...``).

CLI::

    python -m distributed_tpu_torch.diagnostics.critical_path \
        --ledger ledger.jsonl --deps deps.json [--t0 0.0] \
        [--check] [--tolerance 0.01] [--out cp.jsonl]

``--deps`` accepts either a plain ``{key: [dep, ...]}`` JSON object or
a full cluster dump (the ``scheduler.tasks[*].dependencies`` map is
extracted).  File IO is delegated to ``tracing``/``flight_recorder``
helpers: this module is in the sans-io lint scope — the analysis
itself is pure and the simulator imports it.

Phases vocabulary is shared with docs/observability.md ("Decision
ledger & critical-path").
"""

from __future__ import annotations

from typing import Any, Iterable

#: attribution phase vocabulary (docs/observability.md)
PHASES = ("compute", "transfer", "queue", "scheduler")

#: default --check tolerance: attribution must sum to makespan within
#: this fraction (the telescoping walk is exact up to float rounding;
#: 1% is the acceptance bound)
CHECK_TOLERANCE = 0.01


def joined_rows(rows: Iterable[dict]) -> dict[str, list[dict]]:
    """Index ``memory``-joined ledger rows by key, EVERY completion
    kept in t_join order: a key can complete more than once (a dep
    released mid-fetch gets recomputed; a stolen copy finishes after
    the first), and a consumer's walk must anchor on the copy it
    actually consumed, not the newest."""
    by_key: dict[str, list[dict]] = {}
    for row in rows:
        if row.get("type") not in (None, "ledger-row"):
            continue
        if row.get("outcome") != "memory":
            continue
        by_key.setdefault(row.get("key", ""), []).append(row)
    for rows_k in by_key.values():
        rows_k.sort(key=lambda r: r.get("t_join", 0.0))
    return by_key


def _consumed_copy(rows_k: list[dict], t_dec: float) -> dict:
    """The completion of this key the consumer (decided at ``t_dec``)
    actually waited on: the newest copy already in memory at decision
    time, else the earliest copy (defensive — a decision cannot really
    predate every completion of its dep)."""
    best = None
    for r in rows_k:  # sorted by t_join
        if r["t_join"] <= t_dec:
            best = r
        else:
            break
    return best if best is not None else rows_k[0]


def critical_path(rows: Iterable[dict],
                  dependencies: dict[str, Iterable[str]],
                  t0: float | None = None,
                  terminal_keys: Iterable[str] | None = None
                  ) -> dict | None:
    """Walk the completed graph's critical path and attribute makespan.

    ``rows``: ledger records (any mix — only joined ``memory`` rows are
    used).  ``dependencies``: ``{key: [dep_key, ...]}`` for at least
    the tasks on the path (a cluster dump or the simulator's live task
    table both provide it; scattered roots without ledger rows simply
    terminate the walk).  ``t0`` anchors the path start (a simulator
    run passes 0.0); ``None`` anchors at the first path task's own
    decision time, attributing nothing before it.  ``terminal_keys``
    restricts the terminal choice to the workload's WANTED keys — a
    straggler duplicate (a stolen copy finishing after the sink was
    already computed elsewhere) must not extend the path past the
    makespan.

    Returns ``None`` when no joined row exists.
    """
    by_key = joined_rows(rows)
    if not by_key:
        return None
    candidates = [rows_k[-1] for rows_k in by_key.values()]
    if terminal_keys is not None:
        wanted = [
            by_key[k][-1] for k in terminal_keys if k in by_key
        ]
        if wanted:
            candidates = wanted
    terminal = max(candidates, key=lambda r: r["t_join"])

    attribution = dict.fromkeys(PHASES, 0.0)
    by_prefix: dict[str, dict[str, float]] = {}
    path: list[dict] = []
    seen: set[str] = set()

    row: dict | None = terminal
    while row is not None:
        key = row["key"]
        if key in seen:  # defensive: a cyclic deps map must not hang
            break
        seen.add(key)
        t_join = float(row["t_join"])
        t_dec = float(row["t_decision"])
        # each dep contributes the COPY this decision actually waited
        # on (a later recompute/steal duplicate of a dep must not
        # anchor the walk after the consumer's own decision); the
        # predecessor is the dep copy that finished last
        dep_rows = [
            _consumed_copy(by_key[d], t_dec)
            for d in (dependencies.get(key) or ())
            if d in by_key
        ]
        pred = max(dep_rows, key=lambda r: r["t_join"], default=None)
        compute = max(float(row.get("compute", 0.0)), 0.0)
        if pred is not None:
            anchor = float(pred["t_join"])
        elif t0 is not None:
            anchor = min(float(t0), t_dec)
        else:
            anchor = t_dec
        # the whole decomposition lives inside [anchor, t_join] so the
        # telescoping identity (segment span = t_join - anchor, phase
        # sums = makespan) holds EXACTLY and every phase is >= 0 even
        # when the anchor post-dates the decision (the consumed dep
        # copy aged out of the ring and a later recompute anchors the
        # walk) — without this, queue could go negative and the
        # Perfetto segments could overlap
        anchor = min(anchor, t_join)
        start = min(max(t_dec, anchor), t_join)
        scheduler_s = start - anchor
        window = t_join - start  # queue + transfer + compute
        compute = min(compute, window)
        transfer = min(
            max(float(row.get("transfer", 0.0)), 0.0),
            window - compute,
        )
        queue = window - compute - transfer

        prefix = row.get("prefix", "") or ""
        phases = {
            "scheduler": scheduler_s,
            "queue": queue,
            "transfer": transfer,
            "compute": compute,
        }
        agg = by_prefix.setdefault(prefix, dict.fromkeys(PHASES, 0.0))
        for ph, v in phases.items():
            attribution[ph] += v
            agg[ph] += v
        # absolute segment boundaries for the Perfetto track: scheduler
        # then queue then transfer, compute pinned at the tail
        t = anchor
        segs = []
        for ph in ("scheduler", "queue", "transfer"):
            v = phases[ph]
            if v > 0.0:
                segs.append((ph, t, t + v))
                t += v
        segs.append(("compute", t_join - compute, t_join))
        path.append({
            "key": key,
            "prefix": prefix,
            "kind": row.get("kind", ""),
            "stim": row.get("stim", ""),
            "plan_stim": row.get("plan_stim", ""),
            "worker": row.get("worker", ""),
            "t_start": anchor,
            "t_join": t_join,
            "phases": phases,
            "segments": segs,
        })
        row = pred

    path.reverse()
    t_start = path[0]["t_start"]
    t_end = float(terminal["t_join"])
    return {
        "makespan": t_end - t_start,
        "t0": t_start,
        "t1": t_end,
        "n_tasks": len(path),
        "terminal": terminal["key"],
        "attribution": attribution,
        "by_prefix": by_prefix,
        "path": path,
    }


def check(result: dict, tolerance: float = CHECK_TOLERANCE) -> None:
    """Assert the phase attribution sums to the makespan within
    ``tolerance`` (fractional).  Raises ``ValueError`` — the ``--check``
    gate and the ``ledger`` bench-smoke acceptance bound."""
    makespan = float(result["makespan"])
    total = sum(result["attribution"].values())
    bound = max(abs(makespan) * tolerance, 1e-9)
    if abs(total - makespan) > bound:
        raise ValueError(
            f"critical-path attribution sums to {total:.6f}s but the "
            f"makespan is {makespan:.6f}s (|diff| "
            f"{abs(total - makespan):.6f}s > {bound:.6f}s tolerance)"
        )


def to_records(result: dict) -> list[dict]:
    """Flatten an attribution result into JSONL records: one
    ``cp-summary`` plus per-phase ``cp-segment`` rows — the form the
    Perfetto exporter's ``--ledger`` input renders as a named track,
    and what cluster dumps precompute (``DumpArtefact.critical_path``)."""
    out: list[dict] = [{
        "type": "cp-summary",
        "makespan": result["makespan"],
        "t0": result["t0"],
        "t1": result["t1"],
        "n_tasks": result["n_tasks"],
        "terminal": result["terminal"],
        "attribution": result["attribution"],
        "by_prefix": result["by_prefix"],
    }]
    for node in result["path"]:
        for ph, a, b in node["segments"]:
            out.append({
                "type": "cp-segment",
                "key": node["key"],
                "prefix": node["prefix"],
                "phase": ph,
                "t0": a,
                "t1": b,
                "stim": node["stim"],
                "plan_stim": node.get("plan_stim", ""),
                "worker": node["worker"],
            })
    return out


def deps_from_dump(dump: dict) -> dict[str, list[str]]:
    """Extract ``{key: [deps]}`` from a cluster-dump JSON object
    (``scheduler.tasks[*].dependencies``) or pass a plain deps map
    through unchanged."""
    sched = dump.get("scheduler")
    if isinstance(sched, dict) and isinstance(sched.get("tasks"), dict):
        return {
            k: list(t.get("dependencies") or ())
            for k, t in sched["tasks"].items()
        }
    return {k: list(v or ()) for k, v in dump.items()}


def summarize(result: dict) -> str:
    lines = [
        f"critical path: {result['n_tasks']} tasks, makespan "
        f"{result['makespan']:.6f}s (terminal {result['terminal']!r})",
        "attribution:",
    ]
    makespan = result["makespan"] or 1.0
    for ph in PHASES:
        v = result["attribution"][ph]
        lines.append(f"  {ph:10s} {v:12.6f}s  {100 * v / makespan:5.1f}%")
    lines.append("by prefix:")
    for prefix, agg in sorted(
        result["by_prefix"].items(), key=lambda kv: -sum(kv[1].values())
    ):
        total = sum(agg.values())
        parts = " ".join(f"{ph}={agg[ph]:.4f}" for ph in PHASES)
        lines.append(f"  {prefix or '<none>':20s} {total:10.6f}s  {parts}")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    import argparse

    # file IO lives in tracing/flight_recorder (this module is sans-io)
    from distributed_tpu_torch.diagnostics.flight_recorder import load_json
    from distributed_tpu_torch.tracing import dump_journal, load_journal

    parser = argparse.ArgumentParser(
        prog="python -m distributed_tpu_torch.diagnostics.critical_path",
        description=(
            "Walk a completed graph's critical path from a decision-"
            "ledger dump and attribute makespan to compute / transfer "
            "/ queue / scheduler per prefix."
        ),
    )
    parser.add_argument(
        "--ledger", required=True,
        help="ledger JSONL (/ledger route payload, get_ledger output, "
             "or a dumped tail)",
    )
    parser.add_argument(
        "--deps", required=True,
        help="JSON file: {key: [dep, ...]} or a full cluster dump",
    )
    parser.add_argument(
        "--t0", type=float, default=None,
        help="path start anchor (simulator runs pass 0.0); default: "
             "the first path task's own decision time",
    )
    parser.add_argument(
        "--check", action="store_true",
        help="assert attribution sums to makespan within --tolerance",
    )
    parser.add_argument(
        "--tolerance", type=float, default=CHECK_TOLERANCE,
        help=f"--check bound as a makespan fraction "
             f"(default {CHECK_TOLERANCE})",
    )
    parser.add_argument(
        "--out", metavar="OUT",
        help="write cp-summary + cp-segment records as JSONL to OUT "
             "(feed to flight_recorder --ledger for the Perfetto track)",
    )
    args = parser.parse_args(argv)

    rows = load_journal(args.ledger)
    deps = deps_from_dump(load_json(args.deps))
    result = critical_path(rows, deps, t0=args.t0)
    if result is None:
        print("no joined ledger rows in the input")
        return 1
    if args.check:
        check(result, args.tolerance)
        print(
            f"OK: attribution sums to the {result['makespan']:.6f}s "
            f"makespan within {args.tolerance:.2%}"
        )
    if args.out:
        records = to_records(result)
        dump_journal(records, args.out)
        print(f"wrote {len(records)} critical-path records to {args.out}")
    if not args.check and not args.out:
        print(summarize(result))
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    import sys

    sys.exit(main())
