"""Policy A/B driver: the same trace under two config dicts, diffed in
virtual time.

Because the whole cluster runs on the virtual clock, an A/B here
compares POLICIES, not host phases: the box's 2x wall-clock drift
(PERF.md) cannot touch either arm's makespan, and two arms with
identical policies produce identical digests.  Knobs that matter are
the ones the live scheduler reads from config — steal cadence
(``scheduler.work-stealing-interval``), speculative stealing, AMM
interval, saturation — plus the sim-level ones (fleet shape, link
profile, straggler factors) passed through ``sim_kwargs``.
"""

from __future__ import annotations

from typing import Any, Callable

from distributed_tpu_torch.sim.core import ClusterSim


def run_policy(
    n_workers: int,
    trace_factory: Callable[[], Any],
    *,
    seed: int = 0,
    config_overrides: dict[str, Any] | None = None,
    **sim_kwargs: Any,
) -> dict:
    """One arm: build a fresh sim, run the trace, return the report
    (with whole-run digest)."""
    sim = ClusterSim(
        n_workers, seed=seed, config_overrides=config_overrides,
        **sim_kwargs,
    )
    sim.install_digest()
    trace_factory().start(sim)
    report = sim.run()
    report["digest"] = sim.digest()
    report["config_overrides"] = dict(config_overrides or {})
    # critical-path attribution (diagnostics/critical_path.py) while
    # the run's tasks are still resident: per-arm "where did the
    # makespan go", diffed below.  A run that completed nothing (or a
    # chaos arm that forgot its path) reports None.
    cp = sim.critical_path()
    report["critical_path"] = (
        {
            "makespan": cp["makespan"],
            "n_tasks": cp["n_tasks"],
            "attribution": cp["attribution"],
        }
        if cp is not None
        else None
    )
    # the retention half of the A/B contract: after digest + critical
    # path are captured, release everything and require zero retained
    # state — "zero lost keys AND zero retained state" holds for BOTH
    # policy arms (sim/validate.check_census_clean raises otherwise)
    from distributed_tpu_torch.sim.validate import check_census_clean

    report["census"] = check_census_clean(sim)
    return report


def run_ab(
    n_workers: int,
    trace_factory: Callable[[], Any],
    overrides_a: dict[str, Any] | None,
    overrides_b: dict[str, Any] | None,
    *,
    seed: int = 0,
    **sim_kwargs: Any,
) -> dict:
    """Both arms over the same seed + trace; returns
    ``{"a": ..., "b": ..., "diff": ...}`` with the virtual-time deltas
    a policy decision should be judged on."""
    a = run_policy(
        n_workers, trace_factory, seed=seed,
        config_overrides=overrides_a, **sim_kwargs,
    )
    b = run_policy(
        n_workers, trace_factory, seed=seed,
        config_overrides=overrides_b, **sim_kwargs,
    )

    def _delta(field: str) -> float | None:
        va, vb = a.get(field), b.get(field)
        if va is None or vb is None:
            return None
        return vb - va

    def _regret_delta(model: str) -> float | None:
        va = (a.get("ledger") or {}).get("regret_abs_mean", {}).get(model)
        vb = (b.get("ledger") or {}).get("regret_abs_mean", {}).get(model)
        if va is None or vb is None:
            return None
        return vb - va

    cp_a = a.get("critical_path") or {}
    cp_b = b.get("critical_path") or {}
    cp_diff = None
    if cp_a.get("attribution") and cp_b.get("attribution"):
        cp_diff = {
            phase: cp_b["attribution"].get(phase, 0.0)
            - cp_a["attribution"].get(phase, 0.0)
            for phase in cp_a["attribution"]
        }

    return {
        "a": a,
        "b": b,
        "diff": {
            "virtual_makespan_s": _delta("virtual_makespan_s"),
            "makespan_ratio": (
                b["virtual_makespan_s"] / a["virtual_makespan_s"]
                if a.get("virtual_makespan_s") and b.get("virtual_makespan_s")
                else None
            ),
            "steals": _delta("steals"),
            "scheduler_transitions": _delta("scheduler_transitions"),
            "events": _delta("events"),
            # decision–outcome deltas (ledger.py): how each arm's
            # realized regret and makespan attribution moved — the
            # calibration/eval signal ROADMAP item 1's payoff gates
            # will train against
            "regret_abs_mean_constant": _regret_delta("constant"),
            "regret_abs_mean_measured": _regret_delta("measured"),
            "critical_path": cp_diff,
        },
    }
