"""The port's native transition engine (``distributed_tpu_torch/native/engine.cpp``,
a byte copy of the reference's, and ``scheduler/native_engine.py``) against
the reference's, on the CPU.  Every comparison is exact equality.

- Randomized multi-flood runs on ``SchedulerState``: the port's native
  engine, the reference's native engine and the port's Python oracle give
  the same task states, stories, journals, ledger digests, transition
  counters and message multisets; the port's engine counters (escapes by
  reason included) equal the reference engine's.
- ``ClusterSim(native=True, use_device_kernels=True, device="cpu")``, with
  the mirror checked against its from-scratch pack at every view, equals
  the reference's native and oracle runs with its JAX programs on JAX's
  CPU, with and without a placement attached.
- The seams: ``attach(build=True)`` raises when ``g++`` is missing (the
  reference returns None and runs the oracle), ``attach(build=False)``
  with no library built leaves ``state.native`` None, and the oracle's
  quiet selectors (``validate``, a plugin without ``tape_safe``) leave the
  engine's transition count where it was, which is why every native test
  and chip_smoke phase asserts it above 0.

Every engine a test attaches is detached in teardown, so no engine is
left in ``_NATIVE_PENDING`` (a module global) for the next test.
"""

from __future__ import annotations

import random

import pytest
import torch

from distributed_tpu import config as ref_config
from distributed_tpu.scheduler import state as ref_state_mod
from distributed_tpu.scheduler.state import SchedulerState as RefState
from distributed_tpu.sim import ClusterSim as RefSim
from distributed_tpu.sim import SyntheticDag as RefDag
from distributed_tpu_torch import config, native
from distributed_tpu_torch.scheduler import state as state_mod
from distributed_tpu_torch.scheduler.native_engine import NativeEngine
from distributed_tpu_torch.scheduler.state import SchedulerState
from distributed_tpu_torch.scheduler.torch_placement import TorchPlacement
from distributed_tpu_torch.sim import ClusterSim, SyntheticDag
from torch_ref_native import ref_native_lib  # noqa: F401 (autouse: the reference's native library)

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)

PACKAGES = {"port": (config, SchedulerState), "ref": (ref_config, RefState)}

OVR = {
    "scheduler.trace.enabled": False,
    "scheduler.native-engine.enabled": False,  # explicit attach only
    "scheduler.native-engine.min-flood": 0,
}


@pytest.fixture
def engines():
    """Collects the states a test attaches engines to and detaches them
    after it."""
    states = []
    yield states
    for state in states:
        if state.native is not None:
            state.native.detach()
            state.native = None
    assert not state_mod._NATIVE_PENDING and not ref_state_mod._NATIVE_PENDING


class _Spec:
    __slots__ = ()

    def __repr__(self):
        return "<spec>"


SPEC = _Spec()


class _StepClock:
    """Time advances only when the harness steps it, so every engine sees
    the same stamps for the same work."""

    def __init__(self):
        self.t = 0.0

    def step(self):
        self.t += 0.25

    def __call__(self):
        return self.t


def _build(pkg, native_on, engines, n_workers=32, width=64, layers=8, fanin=2, seed=0,
           restrictions=False, actors=False):
    """A state of ``pkg`` ("port" or "ref") with the same seeded graph:
    ``width`` scattered roots and ``layers`` layers, a journal on."""
    cfg, state_cls = PACKAGES[pkg]
    with cfg.set(OVR):
        state = state_cls(validate=False, clock=_StepClock(), mirror=False)
        state.ledger.digest_enabled = True
        if native_on:
            assert state.attach_native(build=True)
            engines.append(state)
        state.trace.journal_start()
        for i in range(n_workers):
            state.add_worker_state(f"sim://w{i}", nthreads=1, memory_limit=2**30, name=f"w{i}")
        rng = random.Random(seed)
        addrs = list(state.workers)
        prev = []
        for i in range(width):
            k = f"root-{i}"
            state.client_desires_keys([k], "c")
            recs, cm, wm = state._transition(k, "memory", "scatter", nbytes=65536,
                                             worker=addrs[i % len(addrs)])
            state._transitions(recs, cm, wm, "scatter")
            prev.append(k)
        tasks, deps, prios, ann = {}, {}, {}, {}
        rank = 0
        for j in range(layers):
            layer = [f"L{j}-{i}" for i in range(width)]
            for k in layer:
                deps[k] = {prev[rng.randrange(len(prev))] for _ in range(fanin)}
                tasks[k] = SPEC
                prios[k] = (rank,)
                rank += 1
                if restrictions and rng.random() < 0.1:
                    ann[k] = {"workers": [addrs[rng.randrange(len(addrs))]],
                              "allow_other_workers": True}
            prev = layer
        state.update_graph_core(tasks, deps, prev, client="c", priorities=prios,
                                annotations_by_key=ann or None,
                                actors=[k for k in tasks if actors and k.endswith("-0")],
                                stimulus_id="graph")
    return state


def _drive(pkg, state, seed=0, err_rate=0.0, release_at=None):
    """Every processing task finished (or erred) by floods until none is
    left; returns the floods' (client, worker) messages."""
    cfg, _ = PACKAGES[pkg]
    rng = random.Random(seed)
    out, rounds = [], 0
    with cfg.set(OVR):
        while True:
            batch = [
                (ts.key, ws.address, f"fin-{rounds}-{i}",
                 {"nbytes": 1024 + (sum(map(ord, ts.key)) % 7) * 512, "typename": "int",
                  "startstops": [{"action": "compute", "start": 0.0, "stop": 0.01}]})
                for ws in state.workers.values()
                for i, ts in enumerate(list(ws.processing))
            ]
            if not batch:
                break
            state.clock.step()
            if err_rate and rng.random() < err_rate:
                out.append(state.stimulus_tasks_erred_batch(
                    [(k, w, s, dict(exception_text="boom")) for k, w, s, _ in batch]))
            else:
                out.append(state.stimulus_tasks_finished_batch(batch))
            if release_at is not None and rounds == release_at:
                out.append(state.client_releases_keys([f"root-{i}" for i in range(4)], "c", "rel"))
            rounds += 1
            assert rounds < 5000
    return out


def _freeze(obj):
    if isinstance(obj, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_freeze(v) for v in obj)
    if isinstance(obj, (str, bytes, int, float, bool)) or obj is None:
        return obj
    return repr(type(obj))


def _canon(rounds):
    """Each flood's messages as a multiset per destination."""
    out = []
    for cm, wm in rounds:
        for d in (cm, wm):
            out.append({dest: sorted((_freeze({k: v for k, v in m.items() if k != "run_spec"})
                                      for m in msgs), key=repr)
                        for dest, msgs in d.items()})
    return out


def _fingerprint(state, rounds):
    return {
        "tasks": {k: (ts.state, ts.processing_on.address if ts.processing_on else None,
                      tuple(ws.address for ws in ts.who_has), tuple(d.key for d in ts.waiters),
                      tuple(d.key for d in ts.waiting_on))
                  for k, ts in state.tasks.items()},
        "stories": [row[:5] for row in state.transition_log],
        "messages": _canon(rounds),
        "journal": list(state.trace.journal),
        "ledger": state.ledger.digest(),
        "transitions": state.transition_counter,
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_multiflood_runs_equal_the_reference_and_the_oracle(seed, engines):
    """Port native == reference native == port oracle, exactly: states,
    stories, journals (the run spec is this module's ``SPEC`` in all three,
    so the journals are equal byte for byte), ledger digests, counters and
    message multisets; and the two engines' counters are equal."""
    runs = {}
    for pkg, native_on in (("port", True), ("ref", True), ("port", False)):
        state = _build(pkg, native_on, engines, seed=seed)
        rounds = _drive(pkg, state, seed=seed, release_at=3)
        runs[pkg, native_on] = (state, _fingerprint(state, rounds))
    port, ref = runs["port", True][0], runs["ref", True][0]
    assert port.native.counters()["transitions"] > 0
    assert runs["port", True][1] == runs["ref", True][1] == runs["port", False][1]
    assert port.native.counters() == ref.native.counters()


@pytest.mark.parametrize("case", ["erred-restricted", "rootish", "actors"])
def test_escapes_by_reason_equal_the_reference(case, engines):
    """The cases that escape to the oracle per key: erred floods (an
    uncompiled arm) with restricted tasks, rootish groups, actors.  The
    port's engine counts the escapes of the reference's by reason, and the
    outputs equal the port's oracle."""
    kw, drive, reason = {
        "erred-restricted": (dict(seed=7, restrictions=True), dict(seed=7, err_rate=0.3), "restricted"),
        "rootish": (dict(n_workers=8, width=40, layers=3, fanin=0, seed=5), dict(seed=5), "rootish"),
        "actors": (dict(n_workers=16, width=24, layers=2, seed=9, actors=True), dict(seed=9), "actor"),
    }[case]
    runs = {}
    for pkg, native_on in (("port", True), ("ref", True), ("port", False)):
        state = _build(pkg, native_on, engines, **kw)
        runs[pkg, native_on] = (state, _fingerprint(state, _drive(pkg, state, **drive)))
    counters = runs["port", True][0].native.counters()
    assert counters["transitions"] > 0 and counters.get(f"escape_{reason}", 0) > 0, counters
    assert counters == runs["ref", True][0].native.counters()
    assert runs["port", True][1] == runs["ref", True][1] == runs["port", False][1]


# BASELINE-like 64 workers x 2 threads, SyntheticDag(8 x 200, fanin 2, 2 layers a chunk)
SIM_SIZE = dict(n_workers=64, nthreads=2, layers=8, width=200)


def _sim(sim_cls, dag_cls, native_on, **kw):
    sim = sim_cls(SIM_SIZE["n_workers"], nthreads=SIM_SIZE["nthreads"], seed=0, validate=False,
                  native=native_on, use_device_kernels=True, **kw)
    sim.install_digest()
    return sim


def _run(sim, dag_cls):
    dag_cls(n_layers=SIM_SIZE["layers"], layer_width=SIM_SIZE["width"], fanin=2, seed=0,
            layers_per_chunk=2).start(sim)
    rep = sim.run()
    return {"digest": sim.digest(), "ledger": sim.state.ledger.digest(),
            "makespan": rep["virtual_makespan_s"], "scheduler": rep["scheduler_transitions"],
            "workers": rep["worker_transitions"], "steals": rep["steals"]}


@pytest.mark.parametrize("placement", [False, True], ids=["no-placement", "placement"])
def test_native_sim_with_device_kernels_equals_the_reference(placement, engines, monkeypatch):
    """The port's native ``ClusterSim`` with its mirror and steal and AMM
    paths on ``device="cpu"`` (and ``TorchPlacement`` when ``placement``)
    against the reference's native and oracle runs with ``JaxPlacement``
    and its JAX programs on JAX's CPU: equal digests, ledger digests,
    makespans and transition counts, exactly, and equal engine counters.
    The mirror checks every view against its from-scratch pack
    (``DTPU_MIRROR_CHECK``), so a view that read rows the native engine had
    not yet replayed would raise; with a placement attached the engine
    escapes ``waiting→processing`` as ``placement-ext``."""
    from distributed_tpu.scheduler.jax_placement import JaxPlacement

    monkeypatch.setenv("DTPU_MIRROR_CHECK", "1")
    port = _sim(ClusterSim, SyntheticDag, True, device="cpu")
    engines.append(port.state)
    refs = {n: _sim(RefSim, RefDag, n) for n in (True, False)}
    engines.append(refs[True].state)
    if placement:
        port.state.placement = TorchPlacement(sync=True, device="cpu", min_batch=64)
        for sim in refs.values():
            jp = JaxPlacement(sync=True, min_batch=64)
            jp.mesh_enabled = False
            jp._mesh = None  # the single-device engine, as the port's
            sim.state.placement = jp
    got = _run(port, SyntheticDag)
    want = {n: _run(sim, RefDag) for n, sim in refs.items()}
    assert got == want[True] == want[False]
    counters = port.state.native.counters()
    assert port.state.native.active() and counters["transitions"] > 0
    assert counters == refs[True].state.native.counters()
    assert port.state.mirror.oracle_checks > 0 and port.state.mirror.oracle_failures == 0
    steal = port.stealing.device_path()
    assert steal.cycles_device > 0 and steal.failures == 0, steal
    assert (counters.get("escape_placement-ext", 0) > 0) == placement, counters


@pytest.fixture
def fresh_library(monkeypatch, tmp_path):
    """No engine library loaded in this process and none built: the
    build directory is empty."""
    monkeypatch.setattr(native, "_engine_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "torch_host")


def test_attach_with_build_raises_without_gpp(fresh_library, monkeypatch):
    """Documented divergence: a build that cannot run raises, where the
    reference's ``attach(build=True)`` returns None and leaves the oracle."""
    monkeypatch.setattr(native, "CXX", "g++-not-installed")
    with pytest.raises(RuntimeError, match="not found"):
        native.load_engine(build=True)
    state = SchedulerState(mirror=False)
    with pytest.raises(RuntimeError, match="g\\+\\+-not-installed not found"):
        state.attach_native(build=True)
    assert state.native is None
    with pytest.raises(RuntimeError, match="not found"):
        ClusterSim(4, native=True)


def test_attach_without_a_built_library_leaves_native_none(fresh_library):
    """``attach(build=False)``, the default, never compiles: with no library
    built the state keeps the oracle, as the reference's does."""
    assert config.get("scheduler.native-engine.enabled") is True
    state = SchedulerState(mirror=False)
    assert state.native is None
    assert state.attach_native() is False and state.native is None
    assert NativeEngine.attach(state) is None
    assert not native.library_path(native.ENGINE_SOURCE, "libdtpu_engine").exists()


def test_the_oracles_quiet_selectors_leave_the_count_unchanged(engines):
    """What picks the oracle without a word: a validating state never
    attaches (``ClusterSim(native=True, validate=True)``), and a plugin
    without ``tape_safe`` makes the engine inactive, so every flood runs in
    Python while the digest stays what the engine would give.  Only the
    engine's transition count tells them apart."""
    sim = ClusterSim(8, seed=0, validate=True, native=True)
    assert sim.state.native is None

    class _Opaque:
        def transition(self, *args, **kwargs):
            pass

    state = _build("port", True, engines, width=16, layers=3)
    before = state.native.counters()["transitions"]  # the graph's own round ran natively
    state.plugins["opaque"] = _Opaque()
    assert not state.native.active()
    _drive("port", state)
    assert state.native.counters()["transitions"] == before
    assert state.native.oracle_transitions > 0
    assert all(ts.state in ("memory", "released", "forgotten") for ts in state.tasks.values())
