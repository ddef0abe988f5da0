"""The port's flight recorder, critical path and sim drivers
(``distributed_tpu_torch/diagnostics/flight_recorder.py``,
``diagnostics/critical_path.py``, ``sim/chaos.py``, ``sim/ab.py``,
``sim/profile_run.py``) against the reference's, on the CPU.  Every
comparison is exact equality unless a test says otherwise.

- The stimulus journal of a sim run equals the reference's record for
  record.  Run specs pickle with their module's path
  (``encode_run_spec``): an ``update-graph`` record is compared with its
  run specs decoded, and its payload digest, which hashes the pickles, is
  checked against the port's own payload instead; every other record,
  digest included, is compared as it is.
- The journal replays through a fresh sim's engine to the recording's
  transition stream and ``state_digest`` (and to the reference's
  stream), also from a file.
- ``ClusterSim.critical_path`` and the critical path's records and summary
  equal the reference's; the Perfetto export, the transition stream and
  the CLIs of both modules give the reference's output on the same input.
- Each chaos scenario, with the device paths on ``device="cpu"``, equals
  the reference's; ``run_ab`` equals the reference's; ``run_profile``'s
  counts equal the reference's (its seconds are wall clock, so only
  their presence is checked).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from distributed_tpu.diagnostics import critical_path as ref_cp
from distributed_tpu.diagnostics import flight_recorder as ref_fr
from distributed_tpu.scheduler import durability as ref_dur
from distributed_tpu.sim import SCENARIOS as REF_SCENARIOS
from distributed_tpu.sim import ClusterSim as RefSim
from distributed_tpu.sim import JournalTrace as RefJournalTrace
from distributed_tpu.sim import SyntheticDag as RefDag
from distributed_tpu.sim import ab as ref_ab
from distributed_tpu.sim import profile_run as ref_profile
from distributed_tpu.tracing import payload_digest
from distributed_tpu_torch.diagnostics import critical_path as cp
from distributed_tpu_torch.diagnostics import flight_recorder as fr
from distributed_tpu_torch.scheduler import durability as dur
from distributed_tpu_torch.sim import SCENARIOS, ClusterSim, JournalTrace, SyntheticDag, ab, profile_run
from distributed_tpu_torch.tracing import dump_journal, load_journal

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PKG = {
    "port": (ClusterSim, SyntheticDag, JournalTrace, fr, dur, cp),
    "ref": (RefSim, RefDag, RefJournalTrace, ref_fr, ref_dur, ref_cp),
}


def _sim(pkg, *, workload=True, journal=True):
    """16 workers x 2 threads with steal cycles and an AMM round every
    0.05 virtual s, the journal on from before ``SyntheticDag(6 x 40)``."""
    sim_cls, dag_cls, *_ = PKG[pkg]
    sim = sim_cls(16, nthreads=2, seed=5, validate=False, native=False, amm_interval=0.05)
    sim.install_digest()
    if journal:
        sim.journal_start()
    if workload:
        dag_cls(n_layers=6, layer_width=40, fanin=2, seed=5, layers_per_chunk=2).start(sim)
    return sim


def _norm(record, module):
    """A journal record with its run specs decoded (an ``update-graph``
    record's digest hashes their pickles and is set apart)."""
    if record["op"] != "update-graph":
        return record
    payload = dict(record["payload"])
    payload["tasks"] = {k: (type(s).__qualname__, repr(s))
                        for k, s in ((k, module.decode_run_spec(v))
                                     for k, v in payload["tasks"].items())}
    return {**{k: v for k, v in record.items() if k != "digest"}, "payload": payload}


@pytest.fixture(scope="module")
def recorded():
    """One journaled run in each package: its records, its transition
    stream and state digest, its critical path and its ledger."""
    out = {}
    for pkg in PKG:
        sim = _sim(pkg)
        sim.run()
        fr_mod, dur_mod = PKG[pkg][3], PKG[pkg][4]
        out[pkg] = dict(records=sim.journal(), stream=fr_mod.transition_stream(sim.state),
                        state=dur_mod.state_digest(sim.state), cp=sim.critical_path(),
                        ledger=sim.state.ledger.tail(),
                        deps={k: [d.key for d in ts.dependencies]
                              for k, ts in sim.state.tasks.items()})
    return out


def test_the_journal_equals_the_reference_with_run_specs_decoded(recorded):
    port, ref = recorded["port"]["records"], recorded["ref"]["records"]
    ops = {r["op"] for r in port}
    assert {"update-graph", "tasks-finished-batch", "add-keys", "steal-request"} <= ops
    assert len(port) == len(ref) > 0
    assert [_norm(r, dur) for r in port] == [_norm(r, ref_dur) for r in ref]
    for r in port:
        if r["op"] == "update-graph":
            assert r["digest"] == payload_digest(r["payload"])
    fr.verify_journal(port)


def _graph_rounds_apart(stream, records):
    """A transition stream with the stimulus id of each graph's own round
    set apart: a replay runs that round under ``update-graph``
    (``replay_stimulus_trace`` passes no id), in the reference as in the
    port."""
    graph = {"update-graph"} | {r["stim"] for r in records if r["op"] == "update-graph"}
    return [(k, a, b, "<graph>" if stim in graph else stim) for k, a, b, stim in stream]


def test_the_journal_replays_to_the_recording(recorded):
    """Replayed into a fresh sim set up as the recording one was, the
    journal reproduces the transition stream (each graph's own round under
    its replay id) and the state digest; the reference's journal replays
    to the same stream in the reference."""
    for pkg in PKG:
        fresh = _sim(pkg, workload=False, journal=False)
        records = recorded[pkg]["records"]
        PKG[pkg][2](records).replay(fresh)
        assert PKG[pkg][4].state_digest(fresh.state) == recorded[pkg]["state"]
        got = PKG[pkg][3].transition_stream(fresh.state)
        assert len(got) == len(recorded[pkg]["stream"]) > 0
        assert _graph_rounds_apart(got, records) == _graph_rounds_apart(recorded[pkg]["stream"], records)
    assert recorded["port"]["stream"] == recorded["ref"]["stream"]
    assert recorded["port"]["state"] == recorded["ref"]["state"]


def test_the_journal_survives_a_file(recorded, tmp_path):
    path = str(tmp_path / "journal.jsonl")
    records = recorded["port"]["records"]
    assert dump_journal(records, path) == len(records)
    loaded = load_journal(path)
    fr.verify_journal(loaded)
    fresh = _sim("port", workload=False, journal=False)
    JournalTrace.from_file(path).replay(fresh)
    assert dur.state_digest(fresh.state) == recorded["port"]["state"]


def test_the_critical_path_equals_the_reference(recorded):
    port, ref = recorded["port"]["cp"], recorded["ref"]["cp"]
    assert port is not None and port["n_tasks"] > 0
    cp.check(port)
    assert port == ref
    assert cp.to_records(port) == ref_cp.to_records(ref)
    assert cp.summarize(port) == ref_cp.summarize(ref)
    direct = cp.critical_path(recorded["port"]["ledger"], recorded["port"]["deps"],
                              t0=0.0, terminal_keys=None)
    assert direct == ref_cp.critical_path(recorded["ref"]["ledger"], recorded["ref"]["deps"],
                                          t0=0.0, terminal_keys=None)


def _run_module(module, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-m", module, *args], capture_output=True, text=True,
                          timeout=120, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


def _named(doc):
    """A Perfetto document with its source, which names the package, set
    to the reference's."""
    assert doc["otherData"]["source"] == "distributed_tpu_torch flight recorder"
    return {**doc, "otherData": {**doc["otherData"], "source": "distributed_tpu flight recorder"}}


def test_perfetto_summaries_and_the_clis_equal_the_reference(recorded, tmp_path):
    """The flight recorder's Perfetto export (events, ledger rows and the
    critical path's segments) and summary, and both CLIs (each module's
    ``main``; the port's critical path also through ``python -m``), on the
    same input in each package: the same output, but for the source the
    document names."""
    from distributed_tpu_torch.scheduler.state import SchedulerState
    from distributed_tpu_torch.tracing import to_jsonl

    state = SchedulerState(mirror=False)
    state.trace.enabled = True
    for i in range(4):
        state.add_worker_state(f"tcp://fr:{i}", nthreads=1, memory_limit=2**30, name=f"f{i}")
    state.update_graph_core({f"x-{i}": None for i in range(8)}, {f"x-{i}": set() for i in range(8)},
                            [f"x-{i}" for i in range(8)], client="c", stimulus_id="g")
    events = state.trace.tail()
    assert events
    ledger = recorded["port"]["ledger"]
    cp_records = cp.to_records(recorded["port"]["cp"])
    assert _named(fr.to_perfetto(events, ledger=ledger + cp_records)) == \
        ref_fr.to_perfetto(events, ledger=ledger + cp_records)
    assert fr.summarize(events) == ref_fr.summarize(events)

    src = tmp_path / "trace.jsonl"
    src.write_text(to_jsonl(events))
    outs = {}
    for pkg, module in (("port", fr), ("ref", ref_fr)):
        out = tmp_path / f"{pkg}.json"
        assert module.main(["--input", str(src), "--perfetto", str(out)]) == 0
        outs[pkg] = json.loads(out.read_text())
    assert _named(outs["port"]) == outs["ref"] and outs["port"]["traceEvents"]

    ledger_path, deps_path = tmp_path / "ledger.jsonl", tmp_path / "deps.json"
    dump_journal(ledger, str(ledger_path))
    deps_path.write_text(json.dumps(recorded["port"]["deps"]))
    args = ["--ledger", str(ledger_path), "--deps", str(deps_path), "--t0", "0.0", "--check"]
    assert ref_cp.main([*args, "--out", str(tmp_path / "cp-ref.jsonl")]) == 0
    # the port's as its users run it
    stdout = _run_module("distributed_tpu_torch.diagnostics.critical_path", *args,
                         "--out", str(tmp_path / "cp-port.jsonl"))
    assert "OK" in stdout
    assert (tmp_path / "cp-port.jsonl").read_text() == (tmp_path / "cp-ref.jsonl").read_text()


REPORT_KEYS = ("digest", "virtual_makespan_s", "scheduler_transitions", "worker_transitions",
               "keys_done", "keys_wanted", "steals", "faults")


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_each_chaos_scenario_equals_the_reference(name):
    """Each scenario at its defaults, the port's with the mirror and the
    steal and AMM paths on ``device="cpu"``: no key lost, the census
    clean (each scenario raises otherwise) and the report equal to the
    reference's."""
    assert sorted(SCENARIOS) == sorted(REF_SCENARIOS)
    sim, rep = SCENARIOS[name](use_device_kernels=True, device="cpu")
    _, ref = REF_SCENARIOS[name]()
    keys = REPORT_KEYS + tuple(k for k in ("nosteal_makespan_s", "twin_digest", "bounce_tail_records")
                               if k in ref)
    assert {k: rep[k] for k in keys} == {k: ref[k] for k in keys}
    assert rep["census"]["census_clean"] and sim.state.mirror is not None


def _factory(dag_cls):
    return lambda: dag_cls(n_layers=4, layer_width=24, fanin=2, seed=1, layers_per_chunk=2)


def test_run_ab_equals_the_reference():
    """Two policy arms (work stealing on and off) over one seed and trace:
    both arms' reports, critical paths and the diff equal the
    reference's."""
    a, b = {"scheduler.work-stealing": True}, {"scheduler.work-stealing": False}
    port = ab.run_ab(12, _factory(SyntheticDag), a, b, seed=1, nthreads=2)
    ref = ref_ab.run_ab(12, _factory(RefDag), a, b, seed=1, nthreads=2)
    for arm in ("a", "b"):
        assert {k: port[arm][k] for k in REPORT_KEYS + ("critical_path",)} == \
            {k: ref[arm][k] for k in REPORT_KEYS + ("critical_path",)}
        assert port[arm]["critical_path"] is not None
    assert port["diff"] == ref["diff"]
    one = ab.run_policy(12, _factory(SyntheticDag), seed=1, nthreads=2)
    assert one["digest"] == ref_ab.run_policy(12, _factory(RefDag), seed=1, nthreads=2)["digest"]


def test_run_profile_counts_equal_the_reference():
    """The per-arm wall table at a small size: the transition and task
    counts and the configuration equal the reference's; the seconds are
    the host's clock, so only their presence is checked, and the table
    renders."""
    kw = dict(n_workers=8, layers=4, width=16, chunk=2, seed=0)
    port, ref = profile_run.run_profile(**kw), ref_profile.run_profile(**kw)
    for key in ("v", "config", "n_tasks", "transitions", "worker_transitions"):
        assert port[key] == ref[key], key
    assert port["n_tasks"] > 0
    for role in ("scheduler", "worker"):
        assert port[role]["engine_wall_s"] > 0 and port[role]["arms"]
    assert "per-transition-arm wall table" in profile_run.table_markdown(port)
