"""The fleet mirror's row writes (``distributed_tpu_torch/ops/fleet.py``, K6
and K11 in ``csrc/fleet_scatter.cu``), on the CPU.

- The record buffer that ``pack_records`` fills, and numpy replays of the
  kernel's rule (``replay_k6``: every job in place; ``replay_k11``: every
  job over a copy of its source block, into a block never handed out),
  equal the plain version bit for bit on the very jobs the mirror makes:
  seeded traces with tombstoned slots, growth, all seven fields (int32,
  float32, bool, int8), and 0, 1 and ``cap`` dirty rows.
- Planted faults: a dirty row dropped from the records, and a field's
  values shifted by a row, make each replay differ from the plain version.
- K11's replay never writes a block that an earlier view handed out.
- The views on ``device="cpu"`` still equal the reference mirror's, every
  field, through a churn of adds, removals and occupancy changes.
- The wrappers: the CPU takes the plain version and never the build; any
  other device goes to the kernel, which raises without CUDA.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import test_torch_periodic_cases as pc
from distributed_tpu.scheduler.state import SchedulerState as RefState
from distributed_tpu_torch.ops import _build, fleet
from distributed_tpu_torch.scheduler.mirror import FIELDS, SHARDED_FIELDS, TorchMirror
from test_torch_mirror_sharded import _churn, cpu_mesh

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)

ALL_FIELDS = tuple(name for name, _ in FIELDS)
STATUSES = ("running", "paused", "closing", "init", "gone-away")


# ------------------------------------------------------------- the replays


def replay(records: np.ndarray, nj: int, memory: dict[int, np.ndarray]) -> None:
    """csrc/fleet_scatter.cu's rule on the host: ``memory`` maps each
    device address the records name to a numpy array of its bytes' dtype,
    written in place.  A job copies its source block (if any) into its
    destination, then writes each value at its row, byte for byte."""
    table = records[:nj * fleet.JOB.itemsize].view(fleet.JOB)
    for job in table:
        elem = int(job["elem"])
        assert elem in fleet.ELEM_SIZES
        dst = memory[int(job["dst"])].view(np.uint8).reshape(-1, elem)
        if job["src"]:
            src = memory[int(job["src"])].view(np.uint8).reshape(-1, elem)
            n_block = int(job["n_block"])
            dst[:n_block] = src[:n_block]
        n = int(job["n"])
        rows = records[job["rows"]:job["rows"] + 4 * n].view(np.int32)
        dst[rows] = records[job["vals"]:job["vals"] + elem * n].reshape(n, elem)


def replay_k6(records, nj, memory) -> None:
    """K6: every job writes its destination in place."""
    assert all(int(s) == 0 for s in records[:nj * fleet.JOB.itemsize].view(fleet.JOB)["src"])
    replay(records, nj, memory)


def replay_k11(records, nj, memory, handed_out: set[int]) -> None:
    """K11: every job fills a new block from its source block and its rows;
    no destination is a block an earlier view handed out."""
    table = records[:nj * fleet.JOB.itemsize].view(fleet.JOB)
    for job in table:
        assert int(job["src"]) != 0 and int(job["dst"]) not in handed_out
        assert int(job["n_block"]) == len(memory[int(job["dst"])])
    replay(records, nj, memory)


class Recorder:
    """Stands in for ``fleet.scatter_rows``: each view's jobs are packed,
    replayed on copies of their tensors, run through the plain version and
    the two compared; ``fault`` edits the jobs that are packed and says
    whether the edit changes a value (``detectable``)."""

    def __init__(self, replay_fn, fault=None):
        self.replay_fn, self.fault = replay_fn, fault
        self.views = self.rows = 0
        self.differed = self.detectable = 0

    def __call__(self, jobs, ring=None):
        assert ring is None  # the CPU has no record ring
        packed = jobs
        if self.fault:
            packed, detectable = self.fault(jobs)
            self.detectable += detectable
        records = fleet.pack_records(packed)
        memory = {}
        for job in jobs:
            memory[job.dst.data_ptr()] = job.dst.numpy().copy()
            if job.src is not None:
                memory[job.src.data_ptr()] = job.src.numpy().copy()
        self.replay_fn(records, len(packed), memory)
        fleet.scatter_rows_reference(jobs)
        same = all(np.array_equal(memory[j.dst.data_ptr()].view(np.uint8), j.dst.numpy().view(np.uint8))
                   for j in jobs)
        self.differed += not same
        self.views += 1
        self.rows += len(jobs[0].rows)
        return same


def drop_a_row(jobs):
    """The first job without one of its rows, one whose value changes
    where there is one."""
    job = jobs[0]
    old = (job.src if job.src is not None else job.dst).numpy()
    keep = np.ones(len(job.rows), bool)
    changed = np.flatnonzero(old[job.rows] != job.values)
    keep[changed[0] if len(changed) else 0] = False
    dropped = fleet.Job(job.dst, job.src, job.rows[keep].copy(), job.values[keep])
    return [dropped, *jobs[1:]], len(changed) > 0


def shift_a_field(jobs):
    """The last job's values one row later."""
    job = jobs[-1]
    shifted = np.roll(job.values, 1)
    return ([*jobs[:-1], fleet.Job(job.dst, job.src, job.rows, shifted)],
            not np.array_equal(shifted, job.values))


# ------------------------------------------------------------- the traces


def _remove(state, ws) -> None:
    del state.workers[ws.address]
    state.running.discard(ws)
    state.idle.pop(ws.address, None)
    state.mirror.on_remove_worker(ws)


def _touch(state, ws, rng) -> None:
    """New values in every mirrored field of ``ws``."""
    ws.nthreads = int(rng.integers(1, 9))
    ws.status = STATUSES[int(rng.integers(len(STATUSES)))]
    if ws.status == "running":
        state.running.add(ws)
    else:
        state.running.discard(ws)
    state.update(ws, rng)


def _trace(seed: int, view, steps: int = 12):
    """A seeded fleet on a stand-in state with the mirror on the CPU: adds
    past three capacity doublings, tombstones and their reuse, then views
    after 0, 1, ``cap`` and random numbers of dirty rows.  ``view(mirror)``
    is called after each step."""
    rng = np.random.default_rng(seed)
    state = pc.StandInState()
    mirror = state.mirror = TorchMirror(state, device="cpu", check=True)
    n = 0
    for step in range(steps):
        for _ in range(int(rng.integers(0, 20))):
            state.add_worker(f"tcp://fleet:{n}", int(rng.integers(1, 5)))
            n += 1
        live = list(state.workers.values())
        for ws in rng.choice(live, min(len(live), int(rng.integers(0, 4))), replace=False):
            if len(state.workers) > 1:
                _remove(state, ws)
        live = list(state.workers.values())
        pick = {0: 0, 1: 1, 2: len(live)}.get(step % 4, int(rng.integers(0, len(live) + 1)))
        for ws in rng.choice(live, pick, replace=False):
            _touch(state, ws, rng)
        view(mirror)
    return mirror


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_k6_replay_equals_the_plain_version(seed, monkeypatch):
    rec = Recorder(replay_k6)
    monkeypatch.setattr(fleet, "scatter_rows", rec)

    def view(mirror):
        got = mirror.device_view(ALL_FIELDS)
        for name in ALL_FIELDS:
            assert np.array_equal(got[name].numpy(), getattr(mirror, name)), name

    mirror = _trace(seed, view)
    assert rec.views > 0 and rec.differed == 0
    assert mirror.cap >= 64 and mirror.full_uploads >= 2  # first use and growth


@pytest.mark.parametrize("layout", ["1x1", "4x2", "2x4"])
@pytest.mark.parametrize("seed", [0, 1])
def test_k11_replay_equals_the_plain_version(seed, layout, monkeypatch):
    handed_out: set[int] = set()
    held = []  # every view handed out stays alive: no address is reused
    rec = Recorder(lambda r, nj, m: replay_k11(r, nj, m, handed_out))
    monkeypatch.setattr(fleet, "scatter_blocks", rec)
    mesh = cpu_mesh(layout)

    def view(mirror):
        got = mirror.sharded_device_view(mesh, ALL_FIELDS)
        for name in ALL_FIELDS:
            assert np.array_equal(torch.cat(got[name]).numpy(), getattr(mirror, name)), name
        held.append(got)
        handed_out.update(b.data_ptr() for blocks in got.values() for b in blocks)

    _trace(seed, view)
    assert rec.views > 0 and rec.differed == 0
    # the blocks every view handed out still hold their view's rows
    assert len({id(v[f][0]) for v in held for f in ALL_FIELDS}) > len(ALL_FIELDS)


@pytest.mark.parametrize("fault", [drop_a_row, shift_a_field], ids=["dropped_row", "shifted_field"])
@pytest.mark.parametrize("kernel", ["k6", "k11"])
def test_a_planted_fault_makes_the_replay_differ(kernel, fault, monkeypatch):
    rec = Recorder(replay_k6 if kernel == "k6" else (lambda r, nj, m: replay(r, nj, m)), fault)
    monkeypatch.setattr(fleet, "scatter_rows" if kernel == "k6" else "scatter_blocks", rec)
    mesh = cpu_mesh("4x2")
    _trace(0, (lambda m: m.device_view(ALL_FIELDS)) if kernel == "k6"
           else (lambda m: m.sharded_device_view(mesh, ALL_FIELDS)))
    # every view whose fault changes a value is caught, and most do
    assert rec.differed == rec.detectable and rec.detectable >= rec.views // 2 > 0


@pytest.mark.parametrize("n_dirty", [0, 1, "cap"])
def test_dirty_counts_at_the_edges(n_dirty, monkeypatch):
    """0 dirty rows launch nothing; 1 and every slot of the capacity give
    one job a field, replayed equal to the plain version."""
    rec = Recorder(replay_k6)
    monkeypatch.setattr(fleet, "scatter_rows", rec)
    state = pc.StandInState()
    mirror = state.mirror = TorchMirror(state, device="cpu")
    ws_list = [state.add_worker(f"tcp://edge:{i}", 2) for i in range(64)]
    assert mirror.cap == 64
    mirror.device_view(ALL_FIELDS)
    rng = np.random.default_rng(5)
    pick = ws_list[:{0: 0, 1: 1, "cap": 64}[n_dirty]]
    for ws in pick:
        _touch(state, ws, rng)
    view = mirror.device_view(ALL_FIELDS)
    assert rec.views == (n_dirty != 0) and rec.rows == len(pick) and rec.differed == 0
    for name in ALL_FIELDS:
        assert np.array_equal(view[name].numpy(), getattr(mirror, name))


def test_the_records_layout():
    """The job table first, every section 16-byte aligned, one rows
    section for jobs that share their rows array."""
    dst = [torch.zeros(32, dtype=d) for d in (torch.int32, torch.float32, torch.bool, torch.int8)]
    rows = np.array([3, 7, 31], np.int32)
    vals = [np.array([1, 0, 1]).astype(t) for t in (np.int32, np.float32, np.bool_, np.int8)]
    jobs = [fleet.Job(d, None, rows, v) for d, v in zip(dst, vals)]
    rows_off, vals_off, size = fleet.layout(jobs)
    assert rows_off == [160] * 4  # 4 jobs of 40 B, then the shared rows
    assert vals_off == [176, 192, 208, 224] and size == 240
    rec = fleet.pack_records(jobs)
    table = rec[:160].view(fleet.JOB)
    assert list(table["dst"]) == [d.data_ptr() for d in dst] and not table["src"].any()
    assert list(table["elem"]) == [4, 4, 1, 1] and list(table["n"]) == [3] * 4
    assert np.array_equal(rec[160:172].view(np.int32), rows)
    src = torch.ones(32, dtype=torch.int32)
    jobs2 = [fleet.Job(dst[0], src, rows, vals[0]), fleet.Job(dst[0], src, rows.copy(), vals[0])]
    assert fleet.layout(jobs2)[0] == [80, 96]  # two rows arrays, two sections
    assert fleet.pack_records(jobs2)[:80].view(fleet.JOB)["n_block"].tolist() == [32, 32]


def test_check_jobs_refuses_what_the_kernel_does_not_take():
    rows = np.array([0, 1], np.int32)
    ok = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="1 or 4 bytes"):
        fleet.check_jobs([fleet.Job(torch.zeros(8, dtype=torch.float64), None, rows,
                                    np.zeros(2, np.float64))])
    with pytest.raises(ValueError, match="outside"):
        fleet.check_jobs([fleet.Job(ok, None, np.array([0, 8], np.int32), np.zeros(2, np.int32))])
    with pytest.raises(ValueError, match="source block"):
        fleet.check_jobs([fleet.Job(ok, torch.zeros(4, dtype=torch.int32), rows, np.zeros(2, np.int32))])
    with pytest.raises(ValueError, match="one value"):
        fleet.check_jobs([fleet.Job(ok, None, rows, np.zeros(2, np.int8))])
    assert fleet.check_jobs([fleet.Job(ok, None, rows, np.zeros(2, np.int32))]) == torch.device("cpu")


def test_the_cpu_never_builds_and_other_devices_go_to_the_kernel(monkeypatch):
    def no_build():
        raise AssertionError("the CPU path built the kernels")

    monkeypatch.setattr(_build, "load", no_build)
    row, five = np.array([2], np.int32), np.array([5.0], np.float32)
    dst = torch.zeros(8, dtype=torch.float32)
    fleet.scatter_rows([fleet.Job(dst, None, row, five)])
    block = torch.empty_like(dst)
    fleet.scatter_blocks([fleet.Job(block, dst, row, five * 2)])
    assert dst.tolist() == [0, 0, 5, 0, 0, 0, 0, 0] and block.tolist() == [0, 0, 10, 0, 0, 0, 0, 0]
    meta = torch.zeros(8, dtype=torch.float32, device="meta")
    for scatter, src in ((fleet.scatter_rows, None), (fleet.scatter_blocks, meta)):
        with pytest.raises(RuntimeError, match="CUDA"):
            scatter([fleet.Job(torch.empty_like(meta), src, row, five)])
    # each kernel takes its own view's jobs only
    with pytest.raises(ValueError, match="in place"):
        fleet.scatter_rows_cuda([fleet.Job(block, dst, row, five)], None)
    with pytest.raises(ValueError, match="no source block"):
        fleet.scatter_blocks_cuda([fleet.Job(block, None, row, five)], None)


def test_cpu_views_equal_the_reference_mirrors(monkeypatch):
    """Every field of ``device_view`` and ``sharded_device_view`` on the
    CPU equals the reference mirror's host rows after the same churn, and
    the port's views went through the row writes."""
    calls = []
    for name in ("scatter_rows", "scatter_blocks"):
        real = getattr(fleet, name)
        monkeypatch.setattr(fleet, name, lambda jobs, ring=None, real=real, name=name: (
            calls.append(name), real(jobs, ring)))
    port = RefState()
    TorchMirror.adopt(port, device="cpu")
    ref = RefState()
    for s in (port, ref):
        for i in range(12):
            s.add_worker_state(f"tcp://cmp:{i}", nthreads=2, memory_limit=2**30, name=f"w{i}")
    rngs = [np.random.default_rng(9), np.random.default_rng(9)]
    mesh = cpu_mesh("2x2")
    for step in range(30):
        for s, rng in zip((port, ref), rngs):
            _churn(s, rng, step)
        ref.mirror.refresh()
        view = port.mirror.device_view(ALL_FIELDS)
        sview = port.mirror.sharded_device_view(mesh, SHARDED_FIELDS) if port.mirror.cap % 2 == 0 else None
        for name in ALL_FIELDS:
            want = getattr(ref.mirror, name)
            assert np.array_equal(view[name].numpy(), want), (step, name)
            if sview is not None and name in SHARDED_FIELDS:
                assert np.array_equal(torch.cat(sview[name]).numpy(), want), (step, name)
    assert set(calls) == {"scatter_rows", "scatter_blocks"} and port.mirror.rows_uploaded > 0
