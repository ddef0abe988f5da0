"""Post-run validators: convergence, replica integrity, and legality of
every observed transition against the extracted ``docs/state_machine/``
model.

The model artifacts (drift-gated JSON) list the TABLE edges of
both machines.  Observed log rows record the *resulting* state, which
differs from the requested finish in two documented families:

- **released-routing**: an untable'd pair routes ``start -> released ->
  finish``; the scheduler logs the second hop with start rewritten to
  ``released`` (already a table edge) and some handlers land one more
  table hop inside themselves (e.g. ``released -> waiting`` deciding
  ``no-worker``).  Closure over paths of length <= 2 through table
  edges covers exactly these.
- **cancelled/resumed parking** (worker machine): a released request
  against a still-running task PARKS it (``executing -> cancelled``),
  and a re-want REVERTS the parking (``cancelled -> executing``).  The
  table resolves these under their requested finishes; the enumerated
  ``WORKER_PARKING_PAIRS`` below are their resulting-state spellings.

Everything else observed is a defect.  The chaos scenarios
(sim/chaos.py) assert zero illegal pairs and zero lost keys after
every injected fault.

This module never opens files (the sim package is sans-io-linted):
callers load the model JSON — ``analysis.model`` artifacts under
``docs/state_machine/`` — and pass the edge sets in.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Iterable

if TYPE_CHECKING:
    from distributed_tpu_torch.sim.core import ClusterSim

Pair = tuple

#: resulting-state spellings of the worker machine's cancelled/resumed
#: parking semantics (requested finishes resolve through the table)
WORKER_PARKING_PAIRS = frozenset({
    ("executing", "cancelled"),
    ("long-running", "cancelled"),
    ("flight", "cancelled"),
    ("resumed", "cancelled"),
    ("cancelled", "executing"),
    ("cancelled", "long-running"),
    ("cancelled", "flight"),
    ("resumed", "flight"),
})


def model_edges(model: dict) -> set[Pair]:
    """Edge set of one machine's ``docs/state_machine/*.json`` artifact."""
    return {(t["start"], t["finish"]) for t in model["transitions"]}


def legal_closure(edges: set[Pair], extra: Iterable[Pair] = ()) -> set[Pair]:
    """Table edges, plus paths of length 2 through them (the
    released-routing composition), plus identity pairs, plus ``extra``."""
    by_start: dict[str, set[str]] = {}
    states: set[str] = set()
    for s, f in edges:
        by_start.setdefault(s, set()).add(f)
        states.update((s, f))
    legal = set(edges)
    for s, mids in by_start.items():
        for m in mids:
            for f in by_start.get(m, ()):
                legal.add((s, f))
    legal.update((s, s) for s in states)
    legal.update(extra)
    return legal


class TransitionRecorder:
    """Scheduler plugin collecting every observed (start, finish) pair
    (the transition_log is bounded; this is not)."""

    def __init__(self):
        self.pairs: set[Pair] = set()

    def transition(self, key: str, start: str, finish: str,
                   *args: Any, **kwargs: Any) -> None:
        self.pairs.add((start, finish))


def install_recorder(sim: "ClusterSim") -> TransitionRecorder:
    rec = TransitionRecorder()
    sim.state.plugins["sim-recorder"] = rec
    return rec


def worker_pairs(sim: "ClusterSim") -> set[Pair]:
    """Observed (start, finish) pairs across every worker's transition
    log (bounded deques — fine at chaos-test scale)."""
    out: set[Pair] = set()
    for w in sim.workers.values():
        for _key, start, finish, _stim in w.state.log:
            out.add((start, finish))
    return out


def check_transitions_legal(
    observed: set[Pair], edges: set[Pair], extra: Iterable[Pair] = ()
) -> None:
    legal = legal_closure(edges, extra)
    illegal = {(s, f) for s, f in observed if s != f} - legal
    if illegal:
        raise AssertionError(
            f"transitions outside the docs/state_machine model: "
            f"{sorted(illegal)}"
        )


def check_model_compliance(sim: "ClusterSim", model: dict,
                           recorder: TransitionRecorder | None = None) -> None:
    """Assert every transition either machine took is inside the
    extracted model (+ documented closures).  ``model`` is
    ``{"scheduler": <scheduler.json>, "worker": <worker.json>}``."""
    if recorder is not None:
        check_transitions_legal(
            recorder.pairs, model_edges(model["scheduler"])
        )
    check_transitions_legal(
        worker_pairs(sim), model_edges(model["worker"]),
        extra=WORKER_PARKING_PAIRS,
    )


def check_census_clean(sim: "ClusterSim") -> dict:
    """The retention half of the convergence contract ("zero lost keys
    AND zero retained state", docs/observability.md "State census &
    retention"): release every still-wanted key, drain the forgetting
    cascade, then require

    - every census walk-vs-counter audit to pass (scheduler + every
      alive worker — the maintained counters may not have drifted at
      ANY point, quiesce just makes the walk cheap);
    - the scheduler census to report quiescent;
    - zero non-allowlisted residue on the scheduler census and on
      every alive worker's census.  Residue raises
      :class:`~distributed_tpu_torch.diagnostics.census.CensusResidueError`
      with enriched findings (member sample + ``gc.get_referrers``
      holder identification naming the retaining container).

    With durability enabled, a final snapshot + journal flush runs
    first — the dirty-set families drain by snapshot cadence, and the
    teardown contract is "quiesce AFTER the final snapshot is clean".

    Returns a summary dict for reports/benches.
    """
    from distributed_tpu_torch.diagnostics.census import CensusResidueError

    sim.release_keys(list(sim.keys_wanted))
    sim.run()
    if sim.durability is not None:
        sim.durability.snapshot()
        sim.durability.flush_journal()
    state = sim.state
    censuses = [state.census] + [
        w.state.census for w in sim.workers.values() if w.alive
    ]
    audits = 0
    findings: list[dict] = []
    for c in censuses:
        c.audit()
        audits += 1
        findings.extend(c.residue())
    if not state.census.quiesced():
        raise CensusResidueError(
            "scheduler census does not report quiescent after release "
            f"+ drain: motion={ {m: state.census.families[m].probe() for m in state.census.motion} }"
        )
    if findings:
        for c in censuses:
            c.enrich_findings(findings)
        raise CensusResidueError(
            f"{len(findings)} non-allowlisted census famil"
            f"{'y' if len(findings) == 1 else 'ies'} retained state at "
            f"quiesce: {findings}"
        )
    return {
        "census_clean": True,
        "censuses": len(censuses),
        "audits": audits,
        "families": sum(len(c.families) for c in censuses),
    }


def check_no_lost_keys(sim: "ClusterSim") -> None:
    """The convergence contract every chaos scenario asserts:

    - the workload completed (every wanted key reported in-memory and
      none is flagged lost at the end);
    - every wanted key has a live replica: scheduler ``who_has`` points
      at alive workers whose real ``WorkerState.data`` holds the value;
    - the scheduler's replica model agrees with the fleet (every
      ``has_what`` row is backed by worker-resident data on an alive
      worker);
    - nothing is left in motion (no processing/executing/flight tasks,
      no queued work) once the event heap has drained.
    """
    state = sim.state
    if not sim.workload_done():
        missing = sorted(sim.keys_wanted - sim.keys_done)[:10]
        raise AssertionError(
            f"workload did not converge: {len(sim.keys_wanted - sim.keys_done)}"
            f" wanted keys never reached memory (first: {missing})"
        )
    if sim.keys_lost & sim.keys_wanted:
        raise AssertionError(
            f"wanted keys still lost at convergence: "
            f"{sorted(sim.keys_lost & sim.keys_wanted)[:10]}"
        )
    for key in sorted(sim.keys_wanted):
        ts = state.tasks.get(key)
        if ts is None or ts.state != "memory":
            raise AssertionError(
                f"wanted key {key!r} not in memory "
                f"({ts.state if ts else 'forgotten'})"
            )
        live = [
            ws for ws in ts.who_has
            if sim.workers.get(ws.address) is not None
            and sim.workers[ws.address].alive
            and key in sim.workers[ws.address].state.data
        ]
        if not live:
            raise AssertionError(
                f"wanted key {key!r}: no live replica backs who_has "
                f"{[ws.address for ws in ts.who_has]}"
            )
    for ws in state.workers.values():
        w = sim.workers.get(ws.address)
        for ts in ws.has_what:
            if w is None or not w.alive or ts.key not in w.state.data:
                raise AssertionError(
                    f"replica record {ts.key!r} on {ws.address} has no "
                    "backing worker data"
                )
    stuck = [
        ts for ts in state.tasks.values()
        if ts.state in ("processing", "queued")
    ]
    if stuck:
        raise AssertionError(f"tasks left in motion after drain: {stuck[:10]}")
    for w in sim.workers.values():
        if not w.alive:
            continue
        moving = [
            ts for ts in w.state.tasks.values()
            if ts.state in ("executing", "flight", "ready", "constrained")
        ]
        if moving:
            raise AssertionError(
                f"worker {w.address} left tasks in motion: {moving[:10]}"
            )
