"""Chaos scenario library: injected faults as deterministic events.

Each scenario builds a validated small cluster (state-machine
``validate=True`` on both machines), runs a seeded synthetic workload
with one fault family injected mid-flight, drains to convergence, and
asserts two invariants:

- **zero lost keys** (``validate.check_no_lost_keys``): every wanted
  key ends in memory with a live, worker-backed replica, the replica
  model agrees with the fleet, nothing is left in motion;
- **zero illegal transitions** against the drift-gated
  ``docs/state_machine/`` model (``validate.check_model_compliance``)
  when the caller passes the loaded model artifacts (the sim package
  itself is sans-io and does not open files).

Scenarios return their sim + report for further assertions; every one
is deterministic per (scenario, seed) — the same fault fires at the
same virtual instant against the same event sequence on every run.

The port's copy of ``distributed_tpu/sim/chaos.py``, line for line but
for one seam: every scenario takes ``use_device_kernels=`` and
``device=`` and builds each of its sims with them, so the fleet mirror
and the steal and AMM device paths can run on the card.
"""

from __future__ import annotations

from typing import Any

from distributed_tpu_torch.sim.core import ClusterSim
from distributed_tpu_torch.sim.traces import SyntheticDag
from distributed_tpu_torch.sim.validate import (
    check_census_clean,
    check_model_compliance,
    check_no_lost_keys,
    install_recorder,
)


def _base_sim(n_workers: int, seed: int, **kwargs: Any) -> ClusterSim:
    sim = ClusterSim(n_workers, seed=seed, validate=True, **kwargs)
    sim.install_digest()
    return sim


def _base_trace(seed: int, *, n_layers: int = 6, layer_width: int = 24,
                **kwargs: Any) -> SyntheticDag:
    return SyntheticDag(
        n_layers=n_layers, layer_width=layer_width, fanin=2, seed=seed,
        **kwargs,
    )


def _finish(sim: ClusterSim, recorder, model: dict | None) -> dict:
    report = sim.report()
    check_no_lost_keys(sim)
    if model is not None:
        check_model_compliance(sim, model, recorder)
    # digest FIRST: the census gate releases the surviving keys and
    # drains the forgetting cascade, which folds further transitions
    # into the running digest — twin comparisons must use this
    # pre-teardown value
    report["digest"] = sim.digest()
    # the retention half of the invariant: zero lost keys AND zero
    # retained state (docs/observability.md "State census & retention")
    report["census"] = check_census_clean(sim)
    return report


def scenario_worker_death(
    seed: int = 1, n_workers: int = 12, model: dict | None = None,
    kill_at: float = 0.03, n_kills: int = 2,
    use_device_kernels: bool = False, device: Any = None,
) -> tuple[ClusterSim, dict]:
    """Workers die mid-flight — tasks executing there, data only they
    held, steals in flight toward them.  The cluster must recompute the
    lost lineage and converge with every wanted key live."""
    sim = _base_sim(n_workers, seed, use_device_kernels=use_device_kernels,
                    device=device)
    recorder = install_recorder(sim)
    trace = _base_trace(seed)
    trace.start(sim)
    addrs = list(sim.workers)
    for k in range(n_kills):
        sim.kill_worker(
            addrs[(k * 5 + 1) % len(addrs)],
            at=kill_at * (k + 1), detect_delay=0.05,
        )
    sim.run()
    return sim, _finish(sim, recorder, model)


def scenario_partition(
    seed: int = 2, n_workers: int = 12, model: dict | None = None,
    t0: float = 0.02, t1: float = 0.6,
    use_device_kernels: bool = False, device: Any = None,
) -> tuple[ClusterSim, dict]:
    """The data plane splits in half for a window: peer fetches across
    the cut fail, missing-data reports strip stale replicas, the
    refresh/recompute paths carry the cluster over the heal."""
    sim = _base_sim(n_workers, seed, use_device_kernels=use_device_kernels,
                    device=device)
    recorder = install_recorder(sim)
    trace = _base_trace(seed)
    trace.start(sim)
    addrs = list(sim.workers)
    half = len(addrs) // 2
    sim.partition(addrs[:half], addrs[half:], t0, t1)
    sim.run()
    return sim, _finish(sim, recorder, model)


def scenario_straggler(
    seed: int = 3, n_workers: int = 12, model: dict | None = None,
    factor: float = 60.0,
    use_device_kernels: bool = False, device: Any = None,
) -> tuple[ClusterSim, dict]:
    """One worker computes ``factor``x slower.  Work stealing must keep
    the run's makespan within a small multiple of the healthy-fleet
    run instead of serializing behind the straggler; the scenario also
    runs a steal-disabled twin and asserts stealing actually helped."""
    sim = _base_sim(n_workers, seed, use_device_kernels=use_device_kernels,
                    device=device)
    recorder = install_recorder(sim)
    trace = _base_trace(seed)
    trace.start(sim)
    sim.straggler(list(sim.workers)[0], factor)
    sim.run()
    report = _finish(sim, recorder, model)

    # steal-disabled twin over the same seed: the straggler pins its
    # backlog and the makespan blows up — the delta IS the policy value
    twin = _base_sim(n_workers, seed, steal_interval=0,
                     use_device_kernels=use_device_kernels, device=device)
    _base_trace(seed).start(twin)
    twin.straggler(list(twin.workers)[0], factor)
    twin.run()
    check_no_lost_keys(twin)
    check_census_clean(twin)
    report["nosteal_makespan_s"] = twin.makespan
    if not (
        sim.makespan is not None
        and twin.makespan is not None
        and sim.makespan < twin.makespan
    ):
        raise AssertionError(
            f"stealing did not beat the straggler: with={sim.makespan} "
            f"without={twin.makespan}"
        )
    return sim, report


def scenario_poison_flood(
    seed: int = 4, n_workers: int = 10, model: dict | None = None,
    at: float = 0.02, n_poison: int = 64,
    use_device_kernels: bool = False, device: Any = None,
) -> tuple[ClusterSim, dict]:
    """A flood of hostile/stale stimuli hits the scheduler ingress:
    completions for unknown keys, finishes from the wrong worker,
    steal-responses with forged stimulus ids, unknown ops — plus
    free-keys floods for unknown keys at a worker.  The batched
    engine's per-event fault isolation must shrug them all off."""
    sim = _base_sim(n_workers, seed, use_device_kernels=use_device_kernels,
                    device=device)
    recorder = install_recorder(sim)
    trace = _base_trace(seed)
    trace.start(sim)
    addrs = list(sim.workers)
    poison: list[dict] = []
    for i in range(n_poison):
        poison.append({
            "op": "task-finished", "key": f"ghost-{i}",
            "stimulus_id": f"poison-fin-{i}", "nbytes": 1,
        })
    poison.append({
        "op": "task-finished", "key": "c0L0-0",
        "worker": addrs[-1], "stimulus_id": "poison-wrong-worker",
        "nbytes": 1,
    })
    poison.extend((
        {"op": "steal-response", "key": "c0L0-1",
         "state": "ready", "stimulus_id": "poison-steal"},
        {"op": "missing-data", "key": "ghost-md",
         "errant_worker": addrs[0], "stimulus_id": "poison-md"},
        {"op": "reschedule", "key": "ghost-rs",
         "stimulus_id": "poison-rs"},
        {"op": "add-keys", "keys": ["ghost-ak"],
         "stimulus_id": "poison-ak"},
        {"op": "totally-unknown-op", "stimulus_id": "poison-unk"},  # graft-lint: allow[handler-parity] deliberately-unhandled op: the scenario asserts the ingress fault-isolates it
    ))
    sim.inject_worker_messages(addrs[0], poison, at)
    sim.inject_scheduler_messages(addrs[1], [
        {"op": "free-keys", "keys": [f"ghost-fk-{i}" for i in range(16)],
         "stimulus_id": "poison-fk"},
        {"op": "steal-request", "key": "ghost-sr",
         "stimulus_id": "poison-sr"},
    ], at)
    sim.run()
    report = _finish(sim, recorder, model)
    if report["faults"].get("scheduler-unknown-op", 0) < 1:
        raise AssertionError("poison unknown-op was not fault-isolated")
    return sim, report


def scenario_scheduler_bounce(
    seed: int = 5, n_workers: int = 12, model: dict | None = None,
    bounce_at: float = 0.05, snapshot_interval: float = 0.015,
    native: bool | None = False,
    use_device_kernels: bool = False, device: Any = None,
) -> tuple[ClusterSim, dict]:
    """The scheduler PROCESS dies mid-graph and restarts from its
    durable snapshot + journal tail (scheduler/durability.py;
    docs/durability.md).  Workers keep their data and state machines —
    the real topology of a scheduler bounce.

    Proves the whole recovery contract deterministically:

    - the restored-then-replayed state is bit-identical to the state
      that died (``bounce_scheduler`` asserts the structural digest and
      the transition counter inside the bounce);
    - the run converges with zero lost completed keys and zero
      transitions outside the ``docs/state_machine/`` model;
    - the POST-recovery stream is digest-identical to an unbounced
      same-seed twin — durable capture and recovery are transparent to
      scheduling behavior, steal round-robin cursor included.

    ``native`` selects the transition engine (``False`` = pure-python
    oracle, ``True`` = compiled) — the contract holds across both.
    The native arm runs ``validate=False`` (a validating state never
    admits the compiled engine); model compliance still gates via the
    recorder plugin either way.
    """
    def build() -> ClusterSim:
        if native:
            sim = ClusterSim(n_workers, seed=seed, validate=False,
                             native=True,
                             use_device_kernels=use_device_kernels,
                             device=device)
            sim.install_digest()
            return sim
        return _base_sim(n_workers, seed, native=native,
                         use_device_kernels=use_device_kernels,
                         device=device)

    sim = build()
    recorder = install_recorder(sim)
    trace = _base_trace(seed)
    trace.start(sim)
    sim.enable_durability(snapshot_interval=snapshot_interval)
    sim.bounce_scheduler(at=bounce_at)
    sim.run()
    report = _finish(sim, recorder, model)
    if sim.counters["scheduler_bounces"] != 1:
        raise AssertionError(
            "the bounce never fired: schedule it before the workload "
            f"drains (bounce_at={bounce_at}, "
            f"makespan={sim.makespan})"
        )
    report["bounce_tail_records"] = sim.counters["bounce_tail_records"]
    report["durability_snapshots"] = sim.counters["durability_snapshots"]

    # unbounced same-seed twin WITHOUT durability: capture + bounce +
    # recovery must be invisible in the whole-run transition stream
    twin = build()
    _base_trace(seed).start(twin)
    twin.run()
    check_no_lost_keys(twin)
    # compare digests BEFORE the twin's census teardown, against the
    # bounced run's pre-teardown digest captured in _finish (the gate's
    # release cascade folds into the running digest)
    twin_digest = twin.digest()
    if report["digest"] != twin_digest:
        raise AssertionError(
            "bounced run diverged from the unbounced same-seed twin: "
            f"{report['digest']} != {twin_digest} (recovery is not "
            "transparent)"
        )
    report["twin_digest"] = twin_digest
    check_census_clean(twin)
    return sim, report


SCENARIOS = {
    "worker-death": scenario_worker_death,
    "partition": scenario_partition,
    "straggler": scenario_straggler,
    "poison-flood": scenario_poison_flood,
    "scheduler-bounce": scenario_scheduler_bounce,
}
