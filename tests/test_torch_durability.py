"""The port's scheduler durability (``distributed_tpu_torch/scheduler/durability.py``)
against the reference's, on the CPU.  Every comparison is exact equality.

- ``state_digest`` and every snapshot's rows equal the reference's on the
  same flood.  Run specs pickle with their module's path
  (``encode_run_spec``), so the rows are compared with each run spec
  decoded; the port's rows carry one family the reference's lack,
  ``replicated``, compared against the reference state's own order.
- ``MemorySink`` and ``FileSink`` (under ``tmp_path``) hold the same bytes
  for the same run and restore a state to the live state's digest.
- A snapshot taken while a native flood is still deferred forces its
  replay first, and equals the reference's and the oracle's.
- ``sim/chaos.py::scenario_scheduler_bounce`` in its oracle and native
  arms, with the device paths on ``device="cpu"``, equals the
  reference's; the native arm ran transitions in C++ before and after
  the bounce.
- Two restores the port repairs, each against the reference's unbounced
  run: the recorded idle membership (the reference rebuilds it from the
  model and its bounce raises) and the order of ``replicated_tasks`` (the
  reference re-adds them in task order, and its AMM rounds then drop
  other replicas than its unbounced twin's).
"""

from __future__ import annotations

import pytest
import torch

from distributed_tpu import config as ref_config
from distributed_tpu.graph.spec import TaskSpec as RefTaskSpec
from distributed_tpu.scheduler import durability as ref_dur
from distributed_tpu.scheduler.state import SchedulerState as RefState
from distributed_tpu.sim import ClusterSim as RefSim
from distributed_tpu.sim import SyntheticDag as RefDag
from distributed_tpu.sim.chaos import scenario_scheduler_bounce as ref_bounce
from distributed_tpu_torch import config
from distributed_tpu_torch.graph.spec import TaskSpec
from distributed_tpu_torch.scheduler import durability as dur
from distributed_tpu_torch.scheduler.state import SchedulerState
from distributed_tpu_torch.sim import ClusterSim, SyntheticDag
from distributed_tpu_torch.sim.chaos import scenario_scheduler_bounce
from torch_ref_native import ref_native_lib  # noqa: F401 (autouse: the reference's native library)

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)

PKG = {
    "port": (config, SchedulerState, TaskSpec, dur, ClusterSim, SyntheticDag),
    "ref": (ref_config, RefState, RefTaskSpec, ref_dur, RefSim, RefDag),
}


def _inc(x):
    return x + 1


def _clock():
    """A fixed clock: the snapshots stamp clients' last-seen times."""
    return 100.0


def _flood_state(pkg, n_workers=8, n_tasks=200, native_on=False):
    """``tests/test_durability.py``'s flood: ``n_tasks`` independent tasks
    on ``n_workers`` workers of 2 threads, a host-only state."""
    cfg, state_cls, spec_cls, *_ = PKG[pkg]
    with cfg.set({"scheduler.jax.enabled": False, "scheduler.native-engine.enabled": False}):
        state = state_cls(validate=not native_on, mirror=False, clock=_clock)
        if native_on:
            assert state.attach_native(build=True)
        for i in range(n_workers):
            state.add_worker_state(f"tcp://dur:{i}", nthreads=2, memory_limit=2**30, name=f"d{i}")
        tasks = {f"dur-{i}": spec_cls(_inc, (i,)) for i in range(n_tasks)}
        state.update_graph_core(tasks, {k: set() for k in tasks}, list(tasks),
                                client="dur-client", stimulus_id="dur-graph")
    return state


def _run_flood(state, mgr=None, cadence=0):
    rounds = 0
    while True:
        batch = [(ts.key, ws.address, f"dur-fin-{ts.key}", {"nbytes": 8})
                 for ws in state.workers.values() for ts in list(ws.processing)]
        if not batch:
            return rounds
        state.stimulus_tasks_finished_batch(batch)
        rounds += 1
        if mgr is not None and cadence and rounds % cadence == 0:
            mgr.snapshot()
        assert rounds < 10_000


def _spec_id(spec):
    return None if spec is None else (type(spec).__qualname__, repr(spec))


def _norm_rows(rows, module):
    """Snapshot rows with each task's run spec decoded (the pickles name
    their module) and the port's own ``replicated`` family set apart."""
    rows = dict(rows)
    rows.pop("replicated", None)
    rows["tasks"] = [dict(r, spec=_spec_id(module.decode_run_spec(r["spec"])))
                     for r in rows["tasks"]]
    return rows


def _bodies(module, sink):
    return [module.parse_snapshot(sink.read_snapshot(e)) for e in sink.snapshot_epochs()]


def test_state_digest_and_snapshot_rows_equal_the_reference():
    """The same flood with a base snapshot and deltas every 3 floods in
    both packages: equal state digests, snapshot headers and rows (run
    specs decoded), the same folded image and journal tail."""
    out = {}
    for pkg in PKG:
        module = PKG[pkg][3]
        state = _flood_state(pkg)
        mgr = module.DurabilityManager(state, module.MemorySink(), full_every=10**6,
                                       state_digests=True)
        mgr.attach()
        _run_flood(state, mgr, cadence=3)
        mgr.flush_journal()
        folded, tail, info = module.DurabilityManager.load(mgr.sink)
        bodies = _bodies(module, mgr.sink)
        out[pkg] = dict(
            digest=module.state_digest(state),
            headers=[{k: v for k, v in b.items() if k != "rows"} for b in bodies],
            rows=[_norm_rows(b["rows"], module) for b in bodies],
            folded=_norm_rows(folded, module), tail=tail, info=info,
            replicated=[[r for r in b["rows"].get("replicated", ())] for b in bodies],
            state_replicated=[ts.key for ts in state.replicated_tasks],
        )
    port, ref = out["port"], out["ref"]
    assert len(port["rows"]) >= 3
    assert port["digest"] == ref["digest"]
    for key in ("rows", "folded", "tail", "info"):
        assert port[key] == ref[key], key
    assert [{k: v for k, v in h.items() if k != "digest"} for h in port["headers"]] == \
        [{k: v for k, v in h.items() if k != "digest"} for h in ref["headers"]]
    assert port["replicated"][-1] == ref["state_replicated"] == port["state_replicated"]
    assert ref["replicated"] == [[] for _ in ref["replicated"]]


@pytest.mark.parametrize("sink", ["memory", "file"])
def test_sinks_round_trip(sink, tmp_path):
    """A flood's snapshots and journal through ``MemorySink`` or
    ``FileSink``: the bytes equal the other sink's for the same run, and
    a fresh state restored from the sink has the live state's digest."""
    sinks = {"memory": dur.MemorySink(), "file": dur.FileSink(str(tmp_path / "durable"))}
    states = {}
    for name in (sink, "file" if sink == "memory" else "memory"):
        state = _flood_state("port")
        mgr = dur.DurabilityManager(state, sinks[name], full_every=10**6, state_digests=True)
        mgr.attach()
        _run_flood(state, mgr, cadence=2)
        mgr.flush_journal()
        states[name] = state
    a, b = sinks["memory"], sinks["file"]
    assert a.snapshot_epochs() == b.snapshot_epochs() and len(a.snapshot_epochs()) >= 3
    assert a.journal_epochs() == b.journal_epochs()
    for e in a.snapshot_epochs():
        assert a.read_snapshot(e) == b.read_snapshot(e)
    for e in a.journal_epochs():
        assert a.read_journal(e) == b.read_journal(e)
    if sink == "file":
        assert sorted(p.name for p in (tmp_path / "durable").iterdir())[0] == "journal-00000000.jsonl"
    fresh = SchedulerState(validate=True, mirror=False)
    info = dur.DurabilityManager.restore_into(fresh, sinks[sink])
    assert dur.state_digest(fresh) == dur.state_digest(states[sink])
    assert info["torn_records"] == 0 and info["deltas"] >= 1


def _deferred_case(pkg, native_on):
    """The reference's deferred-flood case: 8 scattered roots, 40 tasks on
    them, durability attached, one flood left parked, a delta snapshot,
    the rest of the work, a last snapshot, a restore."""
    cfg, state_cls, spec_cls, module, *_ = PKG[pkg]
    with cfg.set({"scheduler.jax.enabled": False, "scheduler.work-stealing": False,
                  "scheduler.native-engine.enabled": False,
                  "scheduler.native-engine.min-flood": 0}):
        state = state_cls(validate=False, mirror=False, clock=_clock)
        if native_on:
            assert state.attach_native(build=True)
        addrs = [f"tcp://defer:{i}" for i in range(4)]
        for i, a in enumerate(addrs):
            state.add_worker_state(a, nthreads=2, memory_limit=2**30, name=f"d{i}")
        roots = []
        for i in range(8):
            k = f"defroot-{i}"
            state.client_desires_keys([k], "def-client")
            recs, cm, wm = state._transition(k, "memory", "def-scatter", nbytes=65536,
                                             worker=addrs[i % 4])
            state._transitions(recs, cm, wm, "def-scatter")
            roots.append(k)
        tasks = {f"def-{i}": spec_cls(_inc, (i,)) for i in range(40)}
        deps = {k: {roots[i % 8]} for i, k in enumerate(tasks)}
        state.update_graph_core(tasks, deps, list(tasks), client="def-client",
                                priorities={k: (i,) for i, k in enumerate(tasks)},
                                stimulus_id="def-graph")
        mgr = module.DurabilityManager(state, module.MemorySink(), full_every=10**6,
                                       state_digests=True)
        mgr.attach()
        batch = [(ts.key, ws.address, f"def-fin-{ts.key}", {"nbytes": 8})
                 for ws in state.workers.values() for ts in list(ws.processing)]
        state.stimulus_tasks_finished_batch(batch)
        parked = bool(state.native._pending) if native_on else None
        delta = mgr.snapshot()
        drained = not state.native._pending if native_on else None
        _run_flood(state)
        mgr.snapshot()
        mgr.flush_journal()
        fresh = state_cls(validate=False, mirror=False)
        module.DurabilityManager.restore_into(fresh, mgr.sink)
        out = dict(parked=parked, drained=drained, delta_rows=delta["task_rows"],
                   rows=[_norm_rows(b["rows"], module) for b in _bodies(module, mgr.sink)],
                   digest=module.state_digest(state), restored=module.state_digest(fresh),
                   transitions=state.native.counters()["transitions"] if native_on else None)
        for s in (state, fresh):
            if s.native is not None:
                s.native.detach()
        return out


def test_a_snapshot_while_a_native_flood_is_deferred():
    """The delta snapshot finds the flood's segments parked and replays
    them before it reads the dirty rows; its rows, the last image and
    the restore equal the reference's native run and the port's oracle."""
    port = _deferred_case("port", True)
    assert port["parked"] and port["drained"] and port["transitions"] > 0
    assert port["delta_rows"] > 0
    assert port["restored"] == port["digest"]
    ref = _deferred_case("ref", True)
    oracle = _deferred_case("port", False)
    for key in ("delta_rows", "rows", "digest", "restored"):
        assert port[key] == ref[key] == oracle[key], key


@pytest.mark.parametrize("native_on", [False, True], ids=["oracle", "native"])
def test_scheduler_bounce_scenario_equals_the_reference(native_on, monkeypatch):
    """``scenario_scheduler_bounce`` (12 workers, the bounce at 0.05
    virtual s) with the mirror and the steal and AMM paths on
    ``device="cpu"`` against the reference's, exactly: the digest (equal
    to the unbounced twin's), the tail's records, the snapshots, the
    makespan and the counts.  The native arm ran in C++ before the bounce
    and after it (the transition recorder is ``tape_safe`` in the port)."""
    engines = []
    bounce = ClusterSim._do_bounce

    def probe(self):
        engines.append(self.state.native.counters() if self.state.native else None)
        bounce(self)

    monkeypatch.setattr(ClusterSim, "_do_bounce", probe)
    sim, rep = scenario_scheduler_bounce(native=native_on, use_device_kernels=True, device="cpu")
    _, ref = ref_bounce(native=native_on)
    keys = ("digest", "twin_digest", "bounce_tail_records", "durability_snapshots",
            "virtual_makespan_s", "scheduler_transitions", "worker_transitions", "keys_done",
            "steals")
    assert {k: rep[k] for k in keys} == {k: ref[k] for k in keys}
    assert rep["digest"] == rep["twin_digest"] and rep["census"]["census_clean"]
    assert sim.state.mirror is not None and sim.state.device == torch.device("cpu")
    (before,) = engines
    if native_on:
        assert before["transitions"] > 0 and sim.state.native.counters()["transitions"] > 0
        sim.state.native.detach()
    else:
        assert before is None and sim.state.native is None


def _bounce_vs_twin(pkg, n_workers, width, at):
    """A bounced run (snapshots every 0.05 virtual s, AMM rounds every 0.1)
    and its unbounced twin; the bounced digest, or the bounce's error."""
    *_, sim_cls, dag_cls = PKG[pkg]

    def build():
        sim = sim_cls(n_workers, nthreads=2, seed=0, native=False, amm_interval=0.1)
        sim.install_digest()
        dag_cls(n_layers=6, layer_width=width, fanin=2, seed=0, layers_per_chunk=2).start(sim)
        return sim

    sim = build()
    sim.enable_durability(snapshot_interval=0.05)
    sim.bounce_scheduler(at=at)
    try:
        sim.run()
        bounced = sim.digest()
    except AssertionError as exc:
        bounced = exc
    twin = build()
    twin.run()
    return bounced, twin.digest()


def test_restore_adopts_the_recorded_idle_membership():
    """Documented divergence.  The live idle set changes only when a
    worker is touched, so at a bounce it can hold workers the model would
    not put there on the restored scalars (and lack others).  The
    reference's ``restore_state`` rebuilds it from the model and keeps the
    recorded order only when the two sets agree
    (``distributed_tpu/scheduler/durability.py:861-869``): here they do
    not, and its bounce raises on its own digest check.  The port adopts
    the recorded membership and order, and its bounced run equals the
    unbounced twin, which equals the reference's."""
    port, port_twin = _bounce_vs_twin("port", 32, 100, 0.1)
    ref, ref_twin = _bounce_vs_twin("ref", 32, 100, 0.1)
    assert isinstance(ref, AssertionError) and "restored state digest" in str(ref)
    assert port == port_twin == ref_twin


def test_restore_keeps_the_replicated_tasks_order():
    """Documented divergence.  ``ReduceReplicas`` scans
    ``state.replicated_tasks`` in order, the order tasks gained their
    second replica; the reference's snapshot does not record it and its
    restore re-adds replicas in task order, so its first AMM round after
    the bounce drops other replicas than its unbounced twin's and the
    run diverges though every digest check of the bounce passes.  The
    port records the order (the ``replicated`` family) and restores it:
    its bounced run equals the twin, which equals the reference's."""
    port, port_twin = _bounce_vs_twin("port", 16, 100, 0.1)
    ref, ref_twin = _bounce_vs_twin("ref", 16, 100, 0.1)
    assert isinstance(ref, str) and ref != ref_twin
    assert port == port_twin == ref_twin
