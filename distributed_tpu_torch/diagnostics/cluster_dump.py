"""Cluster-dump explorer (reference cluster_dump.py:111 DumpArtefact).

``Client.dump_cluster_state(filename)`` writes the scheduler's full
state as JSON; this module loads such a dump back and answers the
questions a post-mortem actually asks — which tasks were stuck where,
what a worker held, which story led to a state — without a live
cluster.

    from distributed_tpu_torch.diagnostics.cluster_dump import DumpArtefact

    d = DumpArtefact.from_file("dump.json")
    d.tasks_in_state("processing")
    d.worker_of("my-key")
    d.story("my-key")
    d.workers_summary()
"""

from __future__ import annotations

import json
from typing import Any, Iterable


class DumpArtefact:
    """Queryable view over one ``dump_cluster_state`` snapshot."""

    def __init__(self, state: dict):
        self.state = state or {}
        sched = self.state.get("scheduler") or {}
        self.tasks: dict[str, dict] = dict(sched.get("tasks") or {})
        self.workers: dict[str, dict] = dict(sched.get("workers") or {})
        self.transition_log: list = list(sched.get("transition_log") or [])
        self.events: dict = dict(sched.get("events") or {})
        # flight-recorder causal tails (tracing.py): the scheduler's
        # last-N events plus each node's, shipped in the dump by default
        self.flight_recorder: list = list(
            sched.get("flight_recorder") or []
        )
        self.worker_traces: dict[str, list] = {
            addr: list(evs)
            for addr, evs in (self.state.get("worker_traces") or {}).items()
            if isinstance(evs, list)
        }
        # measured-truth telemetry snapshot (telemetry.py): per-link
        # EWMAs/quantiles, priors, RTTs, divergence summary
        self.telemetry: list = list(sched.get("telemetry") or [])
        # control-plane self-profile tail (diagnostics/selfprofile.py):
        # wall budget, sampled loop/planner tree, stall captures
        self.profile: dict = dict(sched.get("profile") or {})
        # decision–outcome ledger tail + precomputed critical-path
        # summary (ledger.py, diagnostics/critical_path.py)
        led = sched.get("ledger") or {}
        self.ledger: list = list(led.get("rows") or [])
        self.ledger_summary: dict = dict(led.get("summary") or {})
        # state census (diagnostics/census.py): the scheduler's deep
        # snapshot + every worker's, shipped in the dump by default
        self.census: list = list(sched.get("census") or [])
        self.worker_census: dict[str, list] = {
            addr: list(recs)
            for addr, recs in (self.state.get("worker_census") or {}).items()
            if isinstance(recs, list)
        }
        self._critical_path_precomputed: dict | None = (
            dict(led["critical_path"]) if led.get("critical_path") else None
        )

    @classmethod
    def from_file(cls, path: str) -> "DumpArtefact":
        with open(path) as f:
            return cls(json.load(f))

    # ------------------------------------------------------------- queries

    def tasks_in_state(self, *states: str) -> dict[str, dict]:
        """Tasks currently in any of the given states ('' = all)."""
        wanted = set(states)
        return {
            k: t for k, t in self.tasks.items()
            if not wanted or t.get("state") in wanted
        }

    def state_counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for t in self.tasks.values():
            s = t.get("state", "?")
            out[s] = out.get(s, 0) + 1
        return out

    def worker_of(self, key: str) -> Any:
        """Where a task is processing / which workers hold its data."""
        t = self.tasks.get(key)
        if t is None:
            return None
        return {
            "state": t.get("state"),
            "processing_on": t.get("processing_on"),
            "who_has": t.get("who_has"),
        }

    def story(self, *keys: str) -> list:
        """Transition-log rows touching any of the keys OR stimulus ids
        (the post-mortem equivalent of Scheduler.story: a row matches on
        its task key, its stimulus id, or any recommendation key)."""
        keyset = set(keys)
        out = []
        for row in self.transition_log:
            if not row:
                continue
            try:
                key, _start, _finish, recs, stimulus_id = row[:5]
            except ValueError:
                if row[0] in keyset:
                    out.append(row)
                continue
            if (
                key in keyset
                or stimulus_id in keyset
                or (isinstance(recs, dict) and keyset & set(recs))
            ):
                out.append(row)
        return out

    def trace_tail(self, *, cat: str | None = None,
                   stim: str | None = None,
                   node: str | None = None) -> list[dict]:
        """Flight-recorder events from the dump, filtered by category
        and/or stimulus id.  ``node=None`` = the scheduler's tail; a
        worker address selects that node's.  The post-mortem twin of the
        live ``/trace`` route: join a task's ``story`` rows against the
        ingress/engine/egress hops that carried its stimulus."""
        events = (
            self.flight_recorder
            if node is None
            else self.worker_traces.get(node, [])
        )
        return [
            ev for ev in events
            if (cat is None or ev.get("cat") == cat)
            and (stim is None or ev.get("stim") == stim)
        ]

    def stalls(self) -> list[dict]:
        """Stall captures from the dump's self-profile tail — the
        post-mortem twin of the live ``/profile`` head record's
        ``stalls`` list (each carries ``lag_s``, the in-progress
        ``phase``/``stim`` and the blocked loop thread's formatted
        ``traceback``)."""
        return list(self.profile.get("stalls") or [])

    def telemetry_records(self, type_: str | None = None) -> list[dict]:
        """Telemetry snapshot records from the dump, optionally filtered
        by ``type`` (``link`` / ``prior`` / ``rtt`` / ``divergence``):
        the post-mortem twin of the live ``/telemetry`` route — e.g.
        which links' measured bandwidth the cost-model constant was
        lying about when the cluster was dumped."""
        return [
            rec for rec in self.telemetry
            if type_ is None or rec.get("type") == type_
        ]

    def ledger_rows(self, *, kind: str | None = None,
                    outcome: str | None = None) -> list[dict]:
        """Decision–outcome rows from the dump, filtered by decision
        kind and/or outcome — the post-mortem twin of the live
        ``/ledger`` route (ledger.py): e.g. every steal whose realized
        cost overshot its prediction at the moment of the dump."""
        return [
            row for row in self.ledger
            if (kind is None or row.get("kind") == kind)
            and (outcome is None or row.get("outcome") == outcome)
        ]

    def critical_path(self, full: bool = False) -> dict | None:
        """Critical-path attribution for the dumped run: the summary
        the scheduler precomputed at dump time, or — with
        ``full=True`` (or when the dump predates the precompute) — a
        fresh walk over the dump's own ledger rows and task
        dependency map (diagnostics/critical_path.py)."""
        if not full and self._critical_path_precomputed is not None:
            return self._critical_path_precomputed
        from distributed_tpu_torch.diagnostics.critical_path import (
            critical_path,
        )

        deps = {
            k: list(t.get("dependencies") or ())
            for k, t in self.tasks.items()
        }
        return critical_path(self.ledger, deps)

    def census_counts(self, node: str | None = None) -> dict[str, int]:
        """Per-family resident counts from the dump's census section
        (``node=None`` = the scheduler's; a worker address selects that
        node's) — the post-mortem twin of the live ``/census`` route."""
        recs = (
            self.census if node is None
            else self.worker_census.get(node, [])
        )
        return {
            r["family"]: r.get("count", 0)
            for r in recs
            if r.get("type") == "census"
        }

    def census_findings(self) -> list[dict]:
        """Every recorded retention finding across the dump — scheduler
        and workers (family, count, member sample, referrer-derived
        holder chain)."""
        out = [
            r for r in self.census if r.get("type") == "census-finding"
        ]
        for recs in self.worker_census.values():
            out.extend(
                r for r in recs if r.get("type") == "census-finding"
            )
        return out

    def workers_summary(self) -> dict[str, dict]:
        return {
            addr: {
                "status": w.get("status"),
                "nthreads": w.get("nthreads"),
                "processing": len(w.get("processing") or ()),
                "has_what": len(w.get("has_what") or ()),
                "nbytes": w.get("nbytes"),
            }
            for addr, w in self.workers.items()
        }

    def missing_workers(self, expected: Iterable[str]) -> list[str]:
        """Expected addresses absent from the snapshot (post-mortems of
        scale-down / crash events)."""
        return [a for a in expected if a not in self.workers]

    def __repr__(self) -> str:
        return (
            f"<DumpArtefact tasks={len(self.tasks)} "
            f"workers={len(self.workers)} "
            f"log={len(self.transition_log)} rows "
            f"trace={len(self.flight_recorder)} events "
            f"ledger={len(self.ledger)} rows>"
        )
