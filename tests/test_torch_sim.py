"""The port's cluster simulator (``distributed_tpu_torch/sim``) against the
reference's (``distributed_tpu/sim``), on the CPU.

- With the device kernels off and the native engine off, the port's
  ``ClusterSim`` equals the reference's bit for bit: the whole-run
  digest, the decision ledger's digest, the virtual makespan and the
  scheduler's and workers' transition counts, at ``tests/test_sim.py``'s
  small sizes (seeds 0 and 3) and at ``bench.py``'s ``_smoke_sim`` size
  with the steal and AMM cycles live.
- With every device path on ``device="cpu"`` (the mirror K6, the
  placement's plans, the steal plan K7, the AMM drops K8, each the plain
  version of its kernel), two same-seed runs are equal bit for bit and
  lose no key, and the run equals the reference's with its JAX programs
  on JAX's CPU bit for bit.
- The sim's durability, bounce, journal, replay and critical-path methods
  run and give the reference's results.
- The slice runs where the card runs: with ``jax``, ``msgpack``,
  ``cloudpickle``, ``yaml`` and the reference package blocked,
  ``distributed_tpu_torch.sim`` imports, an 8-worker simulation runs to
  its end, and so does a native one with a scheduler bounce.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from distributed_tpu import config as ref_config
from distributed_tpu.sim import ClusterSim as RefSim
from distributed_tpu.sim import SyntheticDag as RefDag
from distributed_tpu.sim.validate import check_census_clean as ref_check_census_clean
from distributed_tpu.sim.validate import check_no_lost_keys as ref_check_no_lost_keys
from distributed_tpu_torch import config
from distributed_tpu_torch.ops import amm as ops_amm
from distributed_tpu_torch.ops import stealing as ops_stealing
from distributed_tpu_torch.scheduler.torch_placement import TorchPlacement
from distributed_tpu_torch.sim import ClusterSim, JournalTrace, SyntheticDag
from distributed_tpu_torch.sim.validate import check_census_clean, check_no_lost_keys

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]

# (workers, layers, width, seed, layers a chunk); the last is bench.py's
# _smoke_sim, whose steal and AMM cycles run at the configured intervals
SIZES = {
    "small-seed0": (8, 6, 16, 0, None),
    "small-seed3": (8, 6, 16, 3, None),
    "smoke48": (48, 12, 90, 0, 3),
}


def _run(sim_cls, dag_cls, size, **kw):
    n_workers, layers, width, seed, chunk = size
    sim = sim_cls(n_workers, seed=seed, validate=True, native=False, **kw)
    sim.install_digest()
    dag_kw = {} if chunk is None else {"layers_per_chunk": chunk}
    dag_cls(n_layers=layers, layer_width=width, fanin=2, seed=seed, **dag_kw).start(sim)
    rep = sim.run()
    return sim, rep


def _fingerprint(sim, rep) -> dict:
    return {
        "digest": sim.digest(),
        "ledger": sim.state.ledger.digest(),
        "makespan": rep["virtual_makespan_s"],
        "scheduler_transitions": rep["scheduler_transitions"],
        "worker_transitions": rep["worker_transitions"],
        "keys_done": rep["keys_done"],
        "steals": rep["steals"],
    }


@pytest.mark.parametrize("size", sorted(SIZES))
def test_sim_equals_the_reference_bit_for_bit(size):
    """Device kernels off, native engine off, validation on: every number
    of the two runs is equal (the digests fold every transition with its
    stimulus id, so this holds the whole run, not only its end)."""
    ref, ref_rep = _run(RefSim, RefDag, SIZES[size])
    ref_check_no_lost_keys(ref)
    port, port_rep = _run(ClusterSim, SyntheticDag, SIZES[size])
    check_no_lost_keys(port)
    assert _fingerprint(port, port_rep) == _fingerprint(ref, ref_rep)
    assert port_rep["keys_done"] >= port_rep["keys_wanted"] > 0
    assert port_rep["ledger"]["digest"] == ref_rep["ledger"]["digest"]
    # the census check releases the wanted keys and drains: the release's
    # transitions fold into both digests alike
    assert check_census_clean(port) == ref_check_census_clean(ref)
    assert port.digest() == ref.digest()


def test_the_reference_and_the_port_share_one_override_dict():
    """The sim's overrides are the reference's key names: the same dict
    sets both packages' configuration."""
    overrides = {"scheduler.work-stealing-interval": "50ms", "scheduler.jax.min-workers": 4}
    with ref_config.set(overrides), config.set(overrides):
        for path, value in overrides.items():
            assert config.get(path) == ref_config.get(path) == value


# virtual seconds between AMM rounds: the configured 2 s is longer than
# the whole smoke run
AMM_INTERVAL = 0.05


def _device_sim(device="cpu"):
    """The smoke size with every device path on ``device``: the mirror,
    a placement that plans each chunk, and the steal and AMM paths opened
    at this fleet (the gates' item floors set to 1, as the periodic tests
    set them; an AMM round every ``AMM_INTERVAL``)."""
    n_workers, layers, width, seed, chunk = SIZES["smoke48"]
    sim = ClusterSim(n_workers, nthreads=2, seed=seed, validate=True, native=False,
                     use_device_kernels=True, device=device, amm_interval=AMM_INTERVAL)
    sim.state.placement = TorchPlacement(sync=True, device=device, min_batch=64)
    sim.stealing.DEVICE_MIN_TASKS = 1
    for policy in sim.amm.policies:
        policy.DEVICE_MIN_TASKS = 1
    sim.install_digest()
    SyntheticDag(n_layers=layers, layer_width=width, fanin=2, seed=seed,
                 layers_per_chunk=chunk).start(sim)
    return sim


def test_sim_with_every_device_path_on_the_cpu_repeats_bit_for_bit():
    """Two same-seed runs with the mirror, the placement, the steal plan
    and the AMM drops on ``device="cpu"``: equal digests, ledger digests,
    makespans and counts; no key lost, the census clean, each path used
    and none failed."""
    runs = []
    for _ in range(2):
        sim = _device_sim()
        rep = sim.run()
        check_no_lost_keys(sim)
        assert rep["keys_done"] >= rep["keys_wanted"] > 0
        fingerprint = _fingerprint(sim, rep)
        check_census_clean(sim)
        steal = sim.stealing.device_path()
        (policy,) = sim.amm.policies
        amm = policy.device_path()
        placement = sim.state.placement
        assert sim.state.mirror is not None and sim.state.device == torch.device("cpu")
        assert steal.launches > 0 and steal.failures == 0, steal
        assert amm.launches > 0 and amm.failures == 0, amm
        assert placement.enabled and placement.plans_computed > 0 and placement.plan_hits > 0
        runs.append({**fingerprint, "k7": steal.launches, "k8": amm.launches,
                     "plans": placement.plans_computed, "after_census": sim.digest()})
    assert runs[0] == runs[1]


def test_device_sim_equals_the_reference_with_jax_on_the_cpu():
    """The same device-on run in both packages: the port's mirror,
    ``TorchPlacement`` and steal and AMM paths on ``device="cpu"`` against
    the reference's mirror, ``JaxPlacement`` and JAX programs on JAX's CPU.
    Every plan of the port's plain versions equals the reference's, so the
    two runs are equal bit for bit."""
    from distributed_tpu.scheduler.jax_placement import JaxPlacement

    port = _device_sim()
    port_rep = port.run()
    n_workers, layers, width, seed, chunk = SIZES["smoke48"]
    ref = RefSim(n_workers, nthreads=2, seed=seed, validate=True, native=False,
                 use_device_kernels=True, amm_interval=AMM_INTERVAL)
    placement = JaxPlacement(sync=True, min_batch=64)
    placement.mesh_enabled = False
    placement._mesh = None  # the single-device engine, as the port's
    ref.state.placement = placement
    ref.stealing.DEVICE_MIN_TASKS = 1
    for policy in ref.amm.policies:
        policy.DEVICE_MIN_TASKS = 1
    ref.install_digest()
    RefDag(n_layers=layers, layer_width=width, fanin=2, seed=seed,
           layers_per_chunk=chunk).start(ref)
    ref_rep = ref.run()
    assert _fingerprint(port, port_rep) == _fingerprint(ref, ref_rep)
    assert port.state.placement.plan == placement.plan
    assert port.state.placement.plans_computed == placement.plans_computed > 0


def test_device_sim_without_a_card_raises():
    """``device=None`` means CUDA: without a card the state's mirror
    raises at construction, and nothing runs on the CPU in its place."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClusterSim(8, use_device_kernels=True)


def test_a_steal_plan_that_fails_is_counted_and_raised(monkeypatch):
    """No fallback: a device steal plan that raises is counted on the
    path and raised out of the run (the reference logs it and steals in
    python)."""
    def broken(*args, **kwargs):
        raise RuntimeError("planted steal failure")

    monkeypatch.setattr(ops_stealing, "plan_steals", broken)
    sim = _device_sim()
    with pytest.raises(RuntimeError, match="planted steal failure"):
        sim.run()
    path = sim.stealing.device_path()
    assert path.failures == 1 and path.launches == 0


def test_an_amm_plan_that_fails_is_counted_and_raised(monkeypatch):
    """The same for the AMM drops: the manager's round logs a failing
    policy, as it does for any policy, and the path keeps the failure."""
    def broken(*args, **kwargs):
        raise RuntimeError("planted drop failure")

    monkeypatch.setattr(ops_amm, "plan_drops", broken)
    sim = _device_sim()
    sim.run()
    (policy,) = sim.amm.policies
    path = policy.device_path()
    assert path.failures >= 1 and path.launches == 0
    assert all("planted drop failure" in str(e) for e in path.errors)


def _method_run(sim_cls, dag_cls, journal_cls, method):
    """One of the sim's durability, journal and critical-path methods on a
    small run (8 workers, ``SyntheticDag(4 x 16)``); what it gives."""
    def build(workload=True):
        sim = sim_cls(8, seed=0, native=False)
        sim.install_digest()
        if workload:
            dag_cls(n_layers=4, layer_width=16, fanin=2, seed=0).start(sim)
        return sim

    sim = build()
    if method == "enable_durability":
        mgr = sim.enable_durability(snapshot_interval=0.02)
        sim.run()
        return (type(mgr).__name__, sim.counters["durability_snapshots"], mgr.sink.snapshot_epochs(),
                mgr.stats.journal_records, sim.digest())
    if method == "bounce_scheduler":
        sim.enable_durability(snapshot_interval=0.02)
        sim.bounce_scheduler(at=0.03)
        sim.run()
        return (sim.counters["scheduler_bounces"], sim.counters["bounce_tail_records"], sim.digest())
    if method == "critical_path":
        sim.run()
        result = sim.critical_path()
        return (result["makespan"], result["n_tasks"], result["attribution"])
    sim.journal_start()
    sim.run()
    records = sim.journal()
    if method == "journal_start":
        return [(r["op"], r["seq"], r["stim"]) for r in records]
    fresh = build(workload=False)
    journal_cls(records).replay(fresh)
    return (fresh.state.transition_counter, sorted(
        (k, ts.state) for k, ts in fresh.state.tasks.items()))


@pytest.mark.parametrize("method", ["enable_durability", "bounce_scheduler", "journal_start",
                                    "critical_path", "journal_replay"])
def test_sim_methods_run_as_the_reference(method):
    """Each method the port's sim once raised for runs, and gives what the
    reference's gives on the same run: snapshots and journal records, a
    bounce and its tail, the journal's records, the critical path, a
    replay's transitions and task states."""
    from distributed_tpu.sim import JournalTrace as RefJournalTrace

    got = _method_run(ClusterSim, SyntheticDag, JournalTrace, method)
    assert got == _method_run(RefSim, RefDag, RefJournalTrace, method)
    assert got and all(x not in (0, None, [], ()) for x in got[:2])


_BLOCKED_RUN = """
import json, sys
for name in ("jax", "jaxlib", "msgpack", "cloudpickle", "yaml", "distributed_tpu"):
    sys.modules[name] = None
from distributed_tpu_torch.sim import ClusterSim, SyntheticDag
from distributed_tpu_torch.sim.validate import check_census_clean, check_no_lost_keys
sim = ClusterSim(8, seed=0, validate=True, native=False)
sim.install_digest()
SyntheticDag(n_layers=6, layer_width=16, fanin=2, seed=0).start(sim)
rep = sim.run()
check_no_lost_keys(sim)
digest = sim.digest()
check_census_clean(sim)
# the native engine and a scheduler bounce (durability, the journal tail)
bounced = ClusterSim(8, seed=0, native=True)
bounced.install_digest()
SyntheticDag(n_layers=6, layer_width=16, fanin=2, seed=0).start(bounced)
bounced.enable_durability(snapshot_interval=0.02)
bounced.bounce_scheduler(at=0.03)
bounced.run()
check_no_lost_keys(bounced)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                ("jax", "jaxlib", "msgpack", "cloudpickle", "yaml", "distributed_tpu")
                and sys.modules[m] is not None)
print(json.dumps({"digest": digest, "done": rep["keys_done"],
                  "wanted": rep["keys_wanted"], "loaded": loaded,
                  "bounced": bounced.digest(), "bounces": bounced.counters["scheduler_bounces"],
                  "native": bounced.state.native.counters()["transitions"]}))
"""


def test_the_sim_runs_without_jax_msgpack_cloudpickle_and_yaml():
    """The card's machine has none of the four: the port's sim imports and
    runs an 8-worker simulation to its end with each of them blocked, and
    its digest is the one this process gets from the reference; so does a
    native run with a scheduler bounce, which ran transitions in C++."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), PYTHONHASHSEED="0")
    out = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["loaded"] == []
    assert got["done"] >= got["wanted"] > 0
    ref, _ = _run(RefSim, RefDag, SIZES["small-seed0"])
    assert got["digest"] == ref.digest()
    twin = RefSim(8, seed=0, native=False)
    twin.install_digest()
    RefDag(n_layers=6, layer_width=16, fanin=2, seed=0).start(twin)
    twin.run()
    assert got["bounces"] == 1 and got["native"] > 0
    assert got["bounced"] == twin.digest()
