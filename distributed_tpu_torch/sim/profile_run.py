"""Seeded sim under the phase-tagged profiler: the per-arm wall table.

ROADMAP item 4 rests on one claim — ">85% of sim wall is the real
scheduler + worker state machines" — and plans to move "the dominant
scalar transition arms" to a compiled core.  This driver makes that
claim a checked, arm-by-arm artifact: it runs a seeded
:class:`~distributed_tpu_torch.sim.ClusterSim` with
``scheduler.profile.arm-attribution`` on, so every scalar transition
arm (``engine.scalar-arm:<start>,<finish>`` scheduler-side,
``wengine.scalar-arm:...`` worker-side) accumulates exact monotonic
wall in the state machines' :class:`~distributed_tpu_torch.diagnostics.
selfprofile.WallBudget`, and emits the table that item 4's compiled
core will be prioritized (which arms first) and validated (did the
measured arms actually shrink) against.

The checked-in artifact lives next to the extracted state-machine model
it complements: ``docs/state_machine/engine_wall.json``.  The drift
gate is deliberately LOOSE (tests/test_profile_run.py): wall *shares*
swing with the box, but the identity of the dominant arms and the
"arms dominate the drain bookkeeping" property (top arms >= 70% of
engine wall — the acceptance bar) are stable.

CLI::

    python -m distributed_tpu_torch.sim.profile_run                  # table
    python -m distributed_tpu_torch.sim.profile_run --out docs/state_machine/engine_wall.json
    python -m distributed_tpu_torch.sim.profile_run --check          # drift gate

Lint note: this is the one file under ``distributed_tpu_torch/sim/`` carved
out of the sans-io rule (graft-lint.toml) — it exists to measure REAL
wall seconds and to write the artifact, both of which the engine/sim
cores themselves must never do.  It still runs under monotonic-time:
every clock read is ``utils.misc.time``.

The port's copy of ``distributed_tpu/sim/profile_run.py``, line for line
but for one seam: ``run_profile`` takes ``use_device_kernels=`` and
``device=`` for its sim.
"""

from __future__ import annotations

import json
from typing import Any

from distributed_tpu_torch.utils.misc import time

#: default artifact location, next to the extracted state-machine model
ARTIFACT = "docs/state_machine/engine_wall.json"

#: arms below this share of engine wall are folded into "(other arms)"
#: in the emitted table — the compiled-core candidates are the head
MIN_SHARE = 0.005


def run_profile(n_workers: int = 48, layers: int = 12, width: int = 90,
                fanin: int = 2, chunk: int = 3, seed: int = 0,
                use_device_kernels: bool = False, device: Any = None) -> dict:
    """One seeded sim run with arm attribution on; returns the wall
    table as a JSON-safe dict (see ``docs/state_machine/engine_wall.json``
    for the shape)."""
    from distributed_tpu_torch.sim import ClusterSim, SyntheticDag

    sim = ClusterSim(
        n_workers,
        seed=seed,
        validate=False,
        config_overrides={"scheduler.profile.arm-attribution": True},
        use_device_kernels=use_device_kernels,
        device=device,
    )
    trace = SyntheticDag(
        n_layers=layers, layer_width=width, fanin=fanin, seed=seed,
        layers_per_chunk=chunk,
    )
    t0 = time()
    trace.start(sim)
    report = sim.run()
    run_wall = time() - t0

    sched = sim.state.wall.snapshot()
    sched_counts = sim.state.wall.snapshot_counts()
    worker_totals: dict[str, float] = {}
    worker_counts: dict[str, int] = {}
    for w in sim.workers.values():
        for phase, secs in w.state.wall.snapshot().items():
            worker_totals[phase] = worker_totals.get(phase, 0.0) + secs
        for phase, n in w.state.wall.snapshot_counts().items():
            worker_counts[phase] = worker_counts.get(phase, 0) + n

    def arm_table(totals: dict[str, float], counts: dict[str, int],
                  prefix: str, drain_phase: str) -> dict:
        # every attributed sub-phase of this engine: scalar arms plus —
        # worker-side — the handler bodies and ensure drains
        arms = {
            k: v for k, v in totals.items()
            if k.startswith(prefix) and k != drain_phase
        }
        drain_self = totals.get(drain_phase, 0.0)
        # self times sum to the inclusive engine wall: the drain's
        # bookkeeping (popitem/merge loops) plus every arm body
        engine_wall = drain_self + sum(arms.values())
        rows = []
        other_s, other_n = 0.0, 0
        for phase, secs in sorted(arms.items(), key=lambda kv: -kv[1]):
            share = secs / engine_wall if engine_wall else 0.0
            if share < MIN_SHARE:
                other_s += secs
                other_n += 1
                continue
            rows.append({
                "arm": phase[len(prefix):],
                "seconds": round(secs, 4),
                "entries": counts.get(phase, 0),
                "share_of_engine": round(share, 4),
            })
        if other_n:
            rows.append({
                "arm": f"(other {other_n} arms)",
                "seconds": round(other_s, 4),
                "entries": sum(
                    counts.get(k, 0) for k in arms
                    if arms[k] / engine_wall < MIN_SHARE
                ) if engine_wall else 0,
                "share_of_engine": round(
                    other_s / engine_wall if engine_wall else 0.0, 4
                ),
            })
        return {
            "engine_wall_s": round(engine_wall, 4),
            "drain_self_s": round(drain_self, 4),
            "arm_wall_s": round(sum(arms.values()), 4),
            "arm_share": round(
                sum(arms.values()) / engine_wall if engine_wall else 0.0, 4
            ),
            "arms": rows,
        }

    scheduler = arm_table(
        sched, sched_counts, "engine.scalar-arm:", "engine.drain"
    )
    worker = arm_table(
        worker_totals, worker_counts, "wengine.", "wengine.stimulus"
    )
    engines_wall = scheduler["engine_wall_s"] + worker["engine_wall_s"]
    return {
        "v": 1,
        "config": {
            "n_workers": n_workers, "layers": layers, "width": width,
            "fanin": fanin, "chunk": chunk, "seed": seed,
        },
        "n_tasks": report.get("keys_done"),
        "transitions": sim.state.transition_counter,
        "worker_transitions": sim.worker_transitions(),
        "run_wall_s": round(run_wall, 3),
        # the ROADMAP item 4 claim, measured: fraction of the whole
        # harness wall spent inside the two transition engines
        "engines_share_of_run": round(
            engines_wall / run_wall if run_wall else 0.0, 4
        ),
        "scheduler": scheduler,
        "worker": worker,
    }


def table_markdown(result: dict) -> str:
    """Human-readable rendering of :func:`run_profile`'s output."""
    lines = [
        f"# per-transition-arm wall table (seed {result['config']['seed']}, "
        f"{result['config']['n_workers']} workers, "
        f"{result['transitions']}+{result['worker_transitions']} "
        "transitions)",
        f"run wall {result['run_wall_s']}s; engines = "
        f"{result['engines_share_of_run'] * 100:.1f}% of it",
        "",
    ]
    for role in ("scheduler", "worker"):
        t = result[role]
        lines.append(
            f"## {role} engine — {t['engine_wall_s']}s wall, arms "
            f"{t['arm_share'] * 100:.1f}%, drain bookkeeping "
            f"{t['drain_self_s']}s"
        )
        lines.append(f"{'arm':42s} {'seconds':>9s} {'entries':>9s} {'share':>7s}")
        for row in t["arms"]:
            lines.append(
                f"{row['arm']:42s} {row['seconds']:9.4f} "
                f"{row['entries']:9d} {row['share_of_engine'] * 100:6.1f}%"
            )
        lines.append("")
    return "\n".join(lines)


def compare_to_artifact(result: dict, artifact: dict) -> list[str]:
    """LOOSE drift gate between a fresh run and the checked-in table.

    Wall seconds and exact shares drift with the box (PERF.md: 2x day to
    day), so the gate pins only the stable structure:

    - every named top-5 arm of the artifact still appears in the fresh
      run's arm set (an arm VANISHING means the engine seams moved and
      the artifact is stale);
    - arms still dominate the engine wall (>= 0.6 here; the >= 0.7
      acceptance bar is asserted on the fresh run by the tier-1 test).
    """
    issues = []
    for role in ("scheduler", "worker"):
        fresh = {
            r["arm"] for r in result[role]["arms"]
            if not r["arm"].startswith("(")
        }
        top5 = [
            r["arm"] for r in artifact[role]["arms"]
            if not r["arm"].startswith("(")
        ][:5]
        missing = [a for a in top5 if a not in fresh]
        if missing:
            issues.append(
                f"{role}: artifact top arms missing from fresh run: "
                f"{missing} (regenerate with --out)"
            )
        if result[role]["arm_share"] < 0.6:
            issues.append(
                f"{role}: arms fell to "
                f"{result[role]['arm_share'] * 100:.1f}% of engine wall "
                "(drain bookkeeping grew?)"
            )
    return issues


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m distributed_tpu_torch.sim.profile_run",
        description=(
            "Run a seeded sim under the phase-tagged profiler and emit "
            "the per-transition-arm wall table (ROADMAP item 4's "
            "prioritization artifact)."
        ),
    )
    parser.add_argument("--workers", type=int, default=48)
    parser.add_argument("--layers", type=int, default=12)
    parser.add_argument("--width", type=int, default=90)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--out", metavar="PATH",
        help=f"write the JSON artifact (checked in at {ARTIFACT})",
    )
    parser.add_argument(
        "--check", metavar="PATH", nargs="?", const=ARTIFACT,
        help="loose drift gate against a checked-in artifact "
             f"(default {ARTIFACT}); non-zero exit on drift",
    )
    args = parser.parse_args(argv)

    result = run_profile(
        n_workers=args.workers, layers=args.layers, width=args.width,
        seed=args.seed,
    )
    print(table_markdown(result))
    rc = 0
    if args.check:
        with open(args.check) as f:
            artifact = json.load(f)
        issues = compare_to_artifact(result, artifact)
        for issue in issues:
            print(f"DRIFT: {issue}")
        rc = 1 if issues else 0
        if not issues:
            print(f"no structural drift vs {args.check}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.out}")
    return rc


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    import sys

    sys.exit(main(sys.argv[1:]))
