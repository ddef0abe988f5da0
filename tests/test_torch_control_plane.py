"""The port's control plane (``distributed_tpu_torch/scheduler/state.py``
and the modules it reads) against the reference's, on the CPU.

- ``SchedulerState`` with ``TorchPlacement(device="cpu")`` against the
  reference's with ``JaxPlacement`` on JAX's CPU, one batch that the
  router sends to the leveled engine and one to the partitioner: the
  same plan and the same ``state`` and ``processing_on`` of every task,
  bit for bit.
- The copies of the host modules (configuration, collections, key
  helpers, graph order, histograms, the t-digest, the periodic callback)
  give what the reference's give on the same inputs, exactly.
- ``attach_native`` attaches the port's native engine (the configuration
  default is the reference's, True), and a journaled ``update_graph``
  records its run specs encoded as the reference's does.
- The documented divergences: a configuration file that cannot be read
  raises, and a state with its mirror on raises without a card unless it
  is given the CPU.
"""

from __future__ import annotations

import asyncio
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_tpu import config as ref_config
from distributed_tpu.graph.order import order as ref_order
from distributed_tpu.graph.spec import TaskSpec as RefTaskSpec
from distributed_tpu.ops import partition as ref_part
from distributed_tpu.scheduler.jax_placement import JaxPlacement
from distributed_tpu.scheduler.state import SchedulerState as RefState
from distributed_tpu.tracing import SECONDS_BUCKETS as REF_BUCKETS
from distributed_tpu.tracing import Histogram as RefHistogram
from distributed_tpu.utils import HeapSet as RefHeapSet
from distributed_tpu.utils import OrderedSet as RefOrderedSet
from distributed_tpu.utils import key_split as ref_key_split
from distributed_tpu.utils.counter import Digest as RefDigest
from distributed_tpu_torch import config, graphs
from distributed_tpu_torch.graph.order import order, validate_order
from distributed_tpu_torch.graph.spec import TaskSpec
from distributed_tpu_torch.ops import partition as part
from distributed_tpu_torch.rpc.core import PeriodicCallback
from distributed_tpu_torch.scheduler.mirror import TorchMirror
from distributed_tpu_torch.scheduler.state import SchedulerState
from distributed_tpu_torch.scheduler.torch_placement import TorchPlacement
from distributed_tpu_torch.tracing import SECONDS_BUCKETS, Histogram
from distributed_tpu_torch.utils import HeapSet, OrderedSet, key_split
from distributed_tpu_torch.utils.counter import Digest

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
N_WORKERS, THREADS = 16, 2


def _inc(x):
    return x + 1


def _graph(n: int, seed: int):
    """The port's seeded random DAG as a task dict: task i depends on up
    to two earlier tasks."""
    _, _, src, dst = graphs.random_dag(n, seed=seed)
    deps: dict[str, set] = {f"t-{i}": set() for i in range(n)}
    for s, d in zip(src.tolist(), dst.tolist()):
        deps[f"t-{d}"].add(f"t-{s}")
    return deps


def _update(state, spec_cls, deps):
    for i in range(N_WORKERS):
        state.add_worker_state(f"tcp://cp:{i}", nthreads=THREADS, memory_limit=2**30,
                               name=f"w{i}")
    tasks = {k: spec_cls(_inc, (1,)) for k in deps}
    state.update_graph_core(tasks, {k: set(v) for k, v in deps.items()}, list(tasks),
                            client="c", stimulus_id="plan-batch")
    return state


def _task_rows(state) -> dict:
    return {k: (ts.state, ts.processing_on.address if ts.processing_on else None)
            for k, ts in state.tasks.items()}


# (batch size, seed, DENSE_LIMIT): the router sends a batch to the
# partitioner while _bucket(T) * lanes <= DENSE_LIMIT, else to the leveled
# engine; the limit is lowered for the leveled batch so a small batch takes
# that route by the router's own rule
ROUTES = {"leveled": (1024, 5, 1024), "partitioner": (600, 6, None)}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_state_with_torch_placement_equals_the_reference(route, monkeypatch):
    """Bit for bit: one ``update_graph_core`` of the same batch into the
    port's state (mirror and plan on the CPU) and the reference's (JAX on
    the CPU, the single-device engine) plans the same hints, and every
    task ends in the same state on the same worker."""
    n, seed, limit = ROUTES[route]
    if limit is not None:
        monkeypatch.setattr(part, "DENSE_LIMIT", limit)
        monkeypatch.setattr(ref_part, "DENSE_LIMIT", limit)
    lanes = N_WORKERS * THREADS
    assert (part._bucket(n) * lanes > part.DENSE_LIMIT) == (route == "leveled")
    deps = _graph(n, seed)
    # the Python oracle in both (a state attaches the native engine where
    # its library is built, which depends on the tests run before)
    oracle = {"scheduler.native-engine.enabled": False}
    placement = TorchPlacement(sync=True, device="cpu", min_batch=64)
    with config.set(oracle):
        state = _update(SchedulerState(placement=placement, device="cpu"), TaskSpec, deps)
    ref_placement = JaxPlacement(sync=True, min_batch=64)
    ref_placement.mesh_enabled = False
    ref_placement._mesh = None  # the single-device engine, as the port's
    with ref_config.set(oracle):
        ref_state = _update(RefState(placement=ref_placement), RefTaskSpec, deps)
    assert state.native is None and ref_state.native is None
    assert isinstance(state.mirror, TorchMirror) and state.device == torch.device("cpu")
    assert placement.enabled and placement.plans_computed == ref_placement.plans_computed == 1
    assert len(placement.plan) > 0 and placement.plan == ref_placement.plan
    if route == "partitioner":
        assert all(follow is None for follow, _ in placement.plan.values())
    else:
        assert any(follow is not None for follow, _ in placement.plan.values())
    rows = _task_rows(state)
    assert rows == _task_rows(ref_state)
    assert sum(s == "processing" for s, _ in rows.values()) > 0
    assert placement.plan_hits == ref_placement.plan_hits > 0
    assert state.transition_counter == ref_state.transition_counter


def test_state_on_the_cpu_and_host_only_states():
    """``device="cpu"`` keeps the mirror's view in CPU tensors;
    ``mirror=False`` is a host-only state that touches no device."""
    state = SchedulerState(device="cpu")
    assert isinstance(state.mirror, TorchMirror) and state.mirror.device == torch.device("cpu")
    host = SchedulerState(mirror=False)
    assert host.mirror is None and host.device is None


def test_state_with_the_mirror_on_needs_a_card():
    """The mirror is on by default (``scheduler.jax.mirror``): without a
    card the state raises unless it is given the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SchedulerState()


def test_attach_native_attaches():
    """The configuration default is the reference's: a state attaches the
    native engine when its library is built (``attach_native(build=True)``
    builds it), the engine is active and runs the graph's round in C++,
    and the state's tasks end as the oracle's."""
    from distributed_tpu_torch.scheduler.native_engine import NativeEngine

    assert config.get("scheduler.native-engine.enabled") is ref_config.get(
        "scheduler.native-engine.enabled") is True
    deps = _graph(300, 2)
    states = []
    for native_on in (True, False):
        with config.set({"scheduler.native-engine.enabled": False}):
            state = SchedulerState(mirror=False)
            assert state.native is None
            if native_on:
                assert state.attach_native(build=True) is True
                assert state.attach_native() is True  # idempotent
            states.append(_update(state, TaskSpec, deps))
    native_state, oracle = states
    assert isinstance(native_state.native, NativeEngine) and native_state.native.active()
    assert native_state.native.counters()["transitions"] > 0
    assert _task_rows(native_state) == _task_rows(oracle)
    # with the library built, a default state attaches it
    attached = SchedulerState(mirror=False)
    assert isinstance(attached.native, NativeEngine)
    for s in (native_state, attached):
        s.native.detach()


def test_journaled_update_graph_encodes_its_run_specs():
    """A journaled ``update_graph`` records its run specs through the
    durability module's encoder: the record equals the reference's with
    the run specs decoded (their pickles name their module) and decodes
    back to the port's ``TaskSpec``."""
    from distributed_tpu.scheduler.durability import decode_run_spec as ref_decode
    from distributed_tpu_torch.scheduler.durability import decode_run_spec

    deps = {"a-0": set(), "b-0": {"a-0"}}
    records = []
    for state_cls, spec_cls, cfg in ((SchedulerState, TaskSpec, config),
                                     (RefState, RefTaskSpec, ref_config)):
        with cfg.set({"scheduler.native-engine.enabled": False}):
            state = state_cls(mirror=False)
        state.trace.journal_start()
        _update(state, spec_cls, deps)
        (rec,) = [r for r in state.trace.journal if r["op"] == "update-graph"]
        records.append(rec)
    port, ref = records
    specs = {k: decode_run_spec(v) for k, v in port["payload"]["tasks"].items()}
    assert all(isinstance(v, TaskSpec) for v in specs.values())
    assert {k: repr(v) for k, v in specs.items()} == {
        k: repr(ref_decode(v)) for k, v in ref["payload"]["tasks"].items()}
    strip = ("digest", "ts")
    assert {k: v for k, v in port.items() if k not in strip and k != "payload"} == \
        {k: v for k, v in ref.items() if k not in strip and k != "payload"}
    assert {k: v for k, v in port["payload"].items() if k != "tasks"} == \
        {k: v for k, v in ref["payload"].items() if k != "tasks"}


def _defaults(cfg) -> dict:
    """The packaged defaults with the one key the port sets apart."""
    out = {k: v for k, v in cfg.defaults.items()}
    out["scheduler"] = dict(out["scheduler"])
    out["scheduler"]["active-memory-manager"] = dict(
        out["scheduler"]["active-memory-manager"], policies=None)
    return out


def test_config_defaults_equal_the_reference():
    """Every key name and default of the reference, ``scheduler.jax.*``
    and the native engine's included, but the AMM policy's class path
    (the port's own ``ReduceReplicas``)."""
    assert _defaults(config) == _defaults(ref_config)
    assert config.get("scheduler.native-engine.min-flood") == 0
    assert config.get("scheduler.active-memory-manager.policies") == [
        {"class": "distributed_tpu_torch.scheduler.amm.ReduceReplicas"}]
    assert config.parse_timedelta("100ms") == ref_config.parse_timedelta("100ms")
    assert config.parse_bytes("64MiB") == ref_config.parse_bytes("64MiB")


_CONFIG_PROBE = """
import sys
if {block_yaml}:
    sys.modules["yaml"] = None
from distributed_tpu_torch import config
print(config.get("scheduler.work-stealing-interval"))
"""


@pytest.mark.parametrize("case", ["no-yaml", "unparsable", "env"])
def test_config_files_that_cannot_be_read_raise(case, tmp_path):
    """Documented divergence: the reference reads a configuration file, or
    skips one it cannot read; the port imports no PyYAML (the card's
    machine has none) and raises at import on any such file, with PyYAML
    blocked or not, parsable or not; the ``DTPU_*`` environment overrides
    work as the reference's."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), DTPU_CONFIG=str(tmp_path))
    block = case == "no-yaml"
    if case == "env":
        env["DTPU_SCHEDULER__WORK_STEALING_INTERVAL"] = "7ms"
    else:
        text = "scheduler: {work-stealing-interval: [" if case == "unparsable" else \
            "scheduler:\n  work-stealing-interval: 30ms\n"
        (tmp_path / "dtpu.yaml").write_text(text)
    if case == "unparsable" and importlib.util.find_spec("yaml") is None:
        pytest.skip("PyYAML is not installed here")
    out = subprocess.run([sys.executable, "-c", _CONFIG_PROBE.format(block_yaml=block)],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    if case == "env":
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "7ms"
        return
    assert out.returncode != 0
    assert "dtpu.yaml" in out.stderr
    assert "reads no YAML files" in out.stderr


@pytest.mark.parametrize("key", ["x-123-abc", "('y', 0, 1)", "sum-aggregate-8f4e",
                                 "rechunk-split-77", b"bytes-key-1", ("tup-le", 3)])
def test_key_split_equals_the_reference(key):
    assert key_split(key) == ref_key_split(key)


def test_collections_keep_the_reference_order():
    """HeapSet and OrderedSet give the reference's orders on the same
    operations (the sim's digests rest on them)."""
    rng = np.random.default_rng(3)
    items = [(int(p), f"k{i}") for i, p in enumerate(rng.integers(0, 20, 200))]
    hs, rhs = HeapSet(key=lambda x: x[0]), RefHeapSet(key=lambda x: x[0])
    os_, ros = OrderedSet(), RefOrderedSet()
    for i, it in enumerate(items):
        for h in (hs, rhs):
            h.add(it)
        for o in (os_, ros):
            o.add(it[1])
        if i % 7 == 3:
            for h in (hs, rhs):
                h.discard(items[i // 2])
            for o in (os_, ros):
                o.discard(items[i // 3][1])
    assert list(os_) == list(ros)
    assert [hs.pop() for _ in range(len(hs))] == [rhs.pop() for _ in range(len(rhs))]


def test_graph_order_equals_the_reference():
    deps = _graph(3000, 9)
    ranks = order(deps)
    validate_order(deps, ranks)
    assert ranks == ref_order(deps)


def test_histogram_and_digest_equal_the_reference():
    """The flight recorder's histogram and the t-digest (the port builds
    its own copy of ``native/tdigest.cpp``) give the reference's numbers
    on the same samples."""
    rng = np.random.default_rng(4)
    samples = rng.lognormal(-6, 1.5, 20_000)
    h, rh = Histogram(SECONDS_BUCKETS), RefHistogram(REF_BUCKETS)
    d, rd = Digest(), RefDigest(block_on_build=True)
    assert d.native and rd.native
    for x in samples.tolist():
        h.observe(x)
        rh.observe(x)
        d.add(x)
        rd.add(x)
    for q in (0.5, 0.9, 0.99):
        assert h.quantile(q) == rh.quantile(q)
        assert d.quantile(q) == rd.quantile(q)
    assert d.count() == rd.count() == len(samples)
    assert d.serialize() == rd.serialize()


def test_periodic_callback_runs_and_stops():
    calls = []

    async def go():
        pc = PeriodicCallback(lambda: calls.append(1), 0.01)
        pc.start()
        assert pc.is_running
        await asyncio.sleep(0.1)
        pc.stop()
        n = len(calls)
        await asyncio.sleep(0.05)
        return n

    n = asyncio.run(go())
    assert n >= 2 and len(calls) == n
