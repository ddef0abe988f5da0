"""K10's two modes in the port's sharded engine (``ops/sharded.py``), on
the CPU: which loop a run takes (:func:`shard_mode`), the wave table the
run-mode launch reads against what the reference's ``_ShardedRunState`` passes its fused
run (``distributed_tpu/ops/leveled.py`` ``_ShardedRunState.dispatch``), and
the run-mode branch of ``ShardedRun`` with the launch's plain version standing
in for the kernel, and ``profile_sharded.py``'s copy of the two-launch loop.

Tolerance: none.  The wave table is compared bit for bit; the run-mode
branch equals the reference's sharded engine bit for bit on every layout
(its plain version adds the shards' partials in shard order, as XLA's CPU
psum does: ``tests/test_torch_sharded.py``).  The kernel itself runs only on
the card (``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from distributed_tpu.ops import leveled as ref_leveled
from distributed_tpu_torch import graphs, profile_sharded
from distributed_tpu_torch.ops import leveled, sharded
from distributed_tpu_torch.ops.comm import LocalShards, ProcessGroupShards

from test_leveled import BW, random_dag, workers
from test_torch_sharded import MESH_LAYOUTS, assert_same, both, cpu_mesh, ref_mesh

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time
torch.set_num_threads(2)

CUDA0, CUDA1, CPU = torch.device("cuda", 0), torch.device("cuda", 1), torch.device("cpu")


def _process_group():
    """A ProcessGroupShards without a process group: the rule reads its type."""
    return object.__new__(ProcessGroupShards)


@pytest.mark.parametrize("comm,devices,body,want", [
    ("local", [CUDA0] * 8, None, "run"),
    ("local", [CUDA0] * 4 + [CUDA1] * 4, None, "step"),
    ("process_group", [CUDA0], None, "step"),
    ("local", [CPU] * 8, None, "plain"),
    ("local", [CUDA0] * 8, (sharded.shard_tentative, sharded.shard_contend), "step"),
    ("local", [CUDA0] * 8, sharded.PLAIN_BODY, "plain"),
], ids=["one_cuda_device", "two_devices", "process_group", "cpu", "explicit_step", "explicit_plain"])
def test_shard_mode_rule(comm, devices, body, want):
    """Run mode only for LocalShards on one CUDA device with the device
    rule; a process group, several devices and an explicit pair keep the
    two-launch loop; the CPU and the plain pair run the plain body."""
    c = LocalShards(cpu_mesh("4x2")) if comm == "local" else _process_group()
    assert sharded.shard_mode(c, devices, body) == want


@pytest.mark.parametrize("D", [1, 2, 8])
def test_wave_table_equals_reference(D, monkeypatch):
    """Each fused run's table (offsets, sizes, span slots; padding slots
    ``(T, 0, Lp - 1)``) as ``_ship`` hands it to the run-mode launch equals
    the ``offs``, ``fs`` and ``widxs`` the reference's ``_ShardedRunState`` passes its
    fused run, bit for bit, run for run."""
    layout = {1: "1x1", 2: "2x1", 8: "8x1"}[D]
    graph = graphs.random_dag(50_000, seed=3)  # two fused runs: 1 wave, then 19 in 32 slots
    fleet = workers(16)
    seen, real = [], ref_leveled._sharded_run_fn

    def spy(*args, **kwargs):
        fn = real(*args, **kwargs)

        def call(*a):
            seen.append(np.stack([np.asarray(x) for x in a[10:13]]))
            return fn(*a)

        return call

    monkeypatch.setattr(ref_leveled, "_sharded_run_fn", spy)
    rp = ref_leveled.pack_graph(*graph, bandwidth=BW)
    ref_leveled.place_graph_leveled_sharded(ref_mesh(layout), rp, *fleet)

    got, ship = [], sharded.ShardedRun._ship

    def shipped(self, *args):
        K = ship(self, *args)
        got.append(self.groups[0].tiles["waves"].numpy().copy())
        return K

    monkeypatch.setattr(sharded.ShardedRun, "_ship", shipped)
    pp = leveled.pack_graph(*graph, bandwidth=BW)
    sharded.place_graph_leveled_sharded(cpu_mesh(layout), pp, *fleet)
    assert len(got) == len(seen) > 1
    for g, want in zip(got, seen):
        assert g.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(g, want)
    assert any((t[1] == 0).any() for t in got), "no padding wave slot in any run"


def _mixed_fleet(rng, W=24):
    nthreads, _, running = workers(W, stopped=(2,))
    return nthreads, rng.uniform(0, 2.0, W).astype(np.float32), running


def _graph_and_fleet(seed, T):
    rng = np.random.default_rng(seed)
    return leveled.pack_graph(*random_dag(rng, T), bandwidth=BW), _mixed_fleet(rng)


@pytest.mark.parametrize("layout", MESH_LAYOUTS)
def test_run_mode_branch_with_the_plain_launch(layout, monkeypatch):
    """``ShardedRun``'s run-mode branch, its launch replaced by the launch's
    plain version (``place_shard_run_reference``, which reads the wave
    table as the kernel does, padding slots skipped): one launch a fused
    run, and the result equal to the reference's sharded engine on the
    same inputs bit for bit."""
    fleet = _mixed_fleet(np.random.default_rng(30))
    launches = []

    def launch(g, rep):
        launches.append(g.shards)
        sharded.place_shard_run_reference(g, rep)

    monkeypatch.setattr(sharded, "shard_mode", lambda comm, devices, body=None: "run")
    monkeypatch.setattr(sharded, "place_shard_run_cuda", launch)
    got, want, packed = both(layout, graphs.random_dag(50_000, seed=3), fleet)
    D = cpu_mesh(layout).size
    assert launches == [list(range(D))] * len(sharded._plan_runs_sharded(packed.offsets, D))
    assert_same(got, want)


@pytest.mark.parametrize("layout", ["2x1", "4x2"])
def test_profile_step_loop_equals_run_waves(layout):
    """``profile_sharded.step_waves_split``, the two-launch loop with a mark
    between its parts, leaves the carry ``ShardedRun.run_waves`` leaves on
    the explicit pair (the wrappers' plain versions on the CPU), run for
    run, with six marks a wave in the parts' order."""
    smoke = profile_sharded._smoke()
    packed = leveled.pack_graph(*graphs.random_dag(50_000, seed=3), bandwidth=BW)
    fleet = _mixed_fleet(np.random.default_rng(33))
    pair = (sharded.shard_tentative, sharded.shard_contend)
    run, waves, plan = smoke._timed_waves(sharded, cpu_mesh(layout), packed, fleet, body=pair)
    assert run.mode == "step"
    fields = ("assign", "choices", "load", "spans")
    waves()
    want = [getattr(rep, f).clone() for rep in run.replicas.values() for f in fields]
    marks = []
    profile_sharded.step_waves_split(torch, run, plan, marks.append)
    got = [getattr(rep, f) for rep in run.replicas.values() for f in fields]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert marks == [None, *profile_sharded.PARTS] * packed.n_levels


def test_run_mode_failure_raises_without_falling_back(monkeypatch):
    """A run-mode launch that fails raises; neither the two-launch loop nor
    the plain body runs in its place."""
    packed, fleet = _graph_and_fleet(31, T=2_000)
    stepped = []

    def refused(g, rep):
        raise RuntimeError("launch refused")

    monkeypatch.setattr(sharded, "shard_mode", lambda comm, devices, body=None: "run")
    monkeypatch.setattr(sharded, "place_shard_run_cuda", refused)
    for name in ("shard_tentative", "shard_contend", "shard_tentative_reference",
                 "shard_contend_reference"):
        monkeypatch.setattr(sharded, name, lambda *a, name=name: stepped.append(name))
    with pytest.raises(RuntimeError, match="launch refused"):
        sharded.place_graph_leveled_sharded(cpu_mesh("2x1"), packed, *fleet)
    assert stepped == []


def test_run_launch_refuses_cpu_tensors():
    """The run-mode wrapper launches the kernel or raises: it has no plain
    path of its own, so CPU shards never reach it."""
    packed, fleet = _graph_and_fleet(32, T=1_000)
    mesh = cpu_mesh("2x1")
    run = sharded.ShardedRun(mesh, packed, packed.n + 4096, 64, *fleet)
    assert run.mode == "plain"
    g = run.groups[0]
    g.shape_for(512)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        sharded.place_shard_run_cuda(g, run.replicas[g.device])


class _IdleStubs:
    """Stand-ins for the card in ``profile_sharded.idle_share``: each
    untraced call's wall is ``wall`` ms, each traced call's window
    ``window`` ms, and the traces report ``device`` ms in turn, one a
    trace, with ``caught`` K10 launches in each (all 6 unless given)."""

    def __init__(self, monkeypatch, device, wall=1.609, window=3.545, caught=None):
        from distributed_tpu_torch import profile_waves

        self.device, self.caught = list(device), list(caught or [6] * len(device))
        self.tracing = False
        self.traces = 0
        self.torch = types.SimpleNamespace(cuda=types.SimpleNamespace(synchronize=lambda: None))
        monkeypatch.setattr(profile_sharded, "_wall_ms",
                            lambda torch, fn: window if self.tracing else wall)
        monkeypatch.setattr(profile_waves, "kernel_times", self.kernel_times)

    def kernel_times(self, torch, fn, tries=3):
        self.tracing = True
        try:
            fn()
        finally:
            self.tracing = False
        ms, n = self.device[self.traces], self.caught[self.traces]
        self.traces += 1
        return {"place_shard_run_kernel": (ms - 0.007, n), "Memcpy HtoD": (0.007, 4)}


def test_idle_share_takes_medians_of_one_population(monkeypatch):
    """One traced call slower than the untraced median (as in a run on an
    H100: device 1.779 ms against a wall of 1.609 ms) no longer gives
    a negative share: the share is the median device time of the traced
    calls over the median wall of the untraced ones, taken in turns.  A
    trace that missed a launch is taken again and not counted."""
    stubs = _IdleStubs(monkeypatch, device=[1.779, 1.0, 1.2, 1.1, 1.2, 1.3],
                       caught=[6, 5, 6, 6, 6, 6])
    out = profile_sharded.idle_share(stubs.torch, lambda: None, launches=6)
    assert 1.0 - 1.779 / 1.609 < 0  # what one traced call against the median read
    assert stubs.traces == 6 and out["traced_calls"] == 5
    assert out["device_ms"] == pytest.approx(1.2) and out["loop_wall_ms"] == 1.609
    assert out["idle_share"] == pytest.approx(1.0 - 1.2 / 1.609)
    assert out["traced_idle_share"] == pytest.approx(1.0 - 1.2 / 3.545)
    assert out["kernel_launches"] == 6 and out["kernel_ms"] == pytest.approx(1.193)


def test_idle_share_still_raises_past_the_wall(monkeypatch):
    """A median device time past the median wall still raises, and so do
    traces that never catch every launch of a call."""
    stubs = _IdleStubs(monkeypatch, device=[1.7, 1.8, 1.65, 1.5, 1.7])
    with pytest.raises(RuntimeError, match="negative idle share"):
        profile_sharded.idle_share(stubs.torch, lambda: None, launches=6)
    stubs = _IdleStubs(monkeypatch, device=[1.0] * 5, caught=[5] * 5)
    with pytest.raises(RuntimeError, match="no trace caught the 6"):
        profile_sharded.idle_share(stubs.torch, lambda: None, launches=6)
