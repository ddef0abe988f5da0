"""The fleet mirror's row writes (``distributed_tpu_torch/ops/fleet.py``, K6
and K11 in ``csrc/fleet_scatter.cu``), on the CPU.

- The mirror's views go down the card's path here
  (``TorchMirror.PLAIN_DEVICE_TYPES`` emptied for the test), through their
  scatter plans, with the plan's launch caught: each view's record buffer, as the plan laid it
  out and the view filled it, is replayed by numpy replays of the
  kernel's rule (``replay_k6``: every job in place, the row count the
  launch's; ``replay_k11``: every job over a copy of its source block,
  into a block never handed out) and equals the plain version on the same
  view bit for bit: seeded traces with tombstoned slots, growth, all seven
  fields (int32, float32, bool, int8), and 0, 1 and ``cap`` dirty rows.
- Planted faults: a dirty row dropped from the records, and a field's
  values shifted by a row, make each replay differ from the plain version.
- The plan's fixed layout at the capacity, and its rebuilds: at first use,
  growth, a new field set and a new mesh, as often as the full uploads and
  packs and at no other time.
- A plan build that fails leaves no tensors behind: the next view uploads
  or packs in full and builds again, and never writes rows through the
  plain version or through a plan of tensors it no longer reads.
- The views on ``device="cpu"`` still equal the reference mirror's, every
  field, through a churn of adds, removals and occupancy changes, through
  the plain version; a view on another device raises and never reaches it.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import test_torch_periodic_cases as pc
from distributed_tpu.scheduler.state import SchedulerState as RefState
from distributed_tpu_torch.ops import _build, fleet
from distributed_tpu_torch.scheduler.mirror import DEVICE_FIELDS, FIELDS, SHARDED_FIELDS, TorchMirror
from test_torch_mirror_sharded import _churn, cpu_mesh

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)

ALL_FIELDS = tuple(name for name, _ in FIELDS)
STATUSES = ("running", "paused", "closing", "init", "gone-away")


# ------------------------------------------------------------- the replays


def replay(records: np.ndarray, nj: int, n: int, memory: dict[int, np.ndarray]) -> None:
    """csrc/fleet_scatter.cu's rule on the host: ``memory`` maps each
    device address the records name to a numpy array of its bytes' dtype,
    written in place.  A job copies its source block (if any) into its
    destination, then writes each value at its row, byte for byte; ``n``
    >= 0 is every job's row count, -1 each job's own."""
    table = records[:nj * fleet.JOB.itemsize].view(fleet.JOB)
    for job in table:
        elem = int(job["elem"])
        assert elem in fleet.ELEM_SIZES
        dst = memory[int(job["dst"])].view(np.uint8).reshape(-1, elem)
        if job["src"]:
            src = memory[int(job["src"])].view(np.uint8).reshape(-1, elem)
            n_block = int(job["n_block"])
            dst[:n_block] = src[:n_block]
        k = n if n >= 0 else int(job["n"])
        rows = records[job["rows"]:job["rows"] + 4 * k].view(np.int32)
        dst[rows] = records[job["vals"]:job["vals"] + elem * k].reshape(k, elem)


def replay_k6(records, nj, n, memory) -> None:
    """K6: every job writes its destination in place, at the launch's row count."""
    assert n >= 0 and not records[:nj * fleet.JOB.itemsize].view(fleet.JOB)["src"].any()
    replay(records, nj, n, memory)


def replay_k11(records, nj, n, memory, handed_out: set[int]) -> None:
    """K11: every job fills a new block from its source block and its rows;
    no destination is a block an earlier view handed out."""
    assert n == -1
    for job in records[:nj * fleet.JOB.itemsize].view(fleet.JOB):
        assert int(job["src"]) != 0 and int(job["dst"]) not in handed_out
        assert int(job["n_block"]) == len(memory[int(job["dst"])])
    replay(records, nj, n, memory)


class Recorder:
    """Stands in for the card under the mirror's planned views: every
    launch of a plan is caught (its buffer, job count and row count), the
    buffer replayed on copies of the tensors it names, the view run
    through the plain version (``fleet.row_jobs`` / ``fleet.part_jobs`` of
    the same call, on the mirror's tensors; the function as it was when the
    recorder was made) and the two compared.
    ``fault(records, nj, n, memory)`` edits the records before the replay
    and says whether the edit changes a value (``detectable``)."""

    def __init__(self, monkeypatch, replay_fn, fault=None, kernel="k6"):
        self.replay_fn, self.fault = replay_fn, fault
        self.views = self.rows = self.launches = 0
        self.differed = self.detectable = 0
        self.caught = None
        self.reference = fleet.scatter_rows_reference
        monkeypatch.setattr(TorchMirror, "PLAIN_DEVICE_TYPES", ())
        monkeypatch.setattr(fleet.ScatterPlan, "launch", lambda plan, slot, nj, n: self.launch(plan, slot, nj, n))
        name = "scatter_rows_cuda" if kernel == "k6" else "scatter_blocks_cuda"
        self.real = getattr(fleet, name)
        monkeypatch.setattr(fleet, name, self.k6 if kernel == "k6" else self.k11)

    def launch(self, plan, slot, nj, n):
        assert plan.device.type == "cpu" and not slot.buf.is_pinned()
        self.caught = (slot.buf.numpy().copy(), nj, n)
        self.launches += 1
        plan.i = (plan.i + 1) % fleet.RING_DEPTH

    def _check(self, jobs, memory):
        records, nj, n = self.caught
        self.caught = None
        if self.fault:
            records, n, detectable = self.fault(records, nj, n, memory)
            self.detectable += detectable
        self.replay_fn(records, nj, n, memory)
        self.reference(jobs)
        same = all(np.array_equal(memory[j.dst.data_ptr()].view(np.uint8), j.dst.numpy().view(np.uint8))
                   for j in jobs)
        self.differed += not same
        self.views += 1
        return same

    def k6(self, plan, rows):
        tensors = plan.groups[0]
        memory = {t.data_ptr(): t.numpy().copy() for t in tensors}
        self.real(plan, rows)
        if len(rows):
            self.rows += len(rows)
            self._check(fleet.row_jobs(tensors, plan.hosts, rows), memory)

    def k11(self, plan, parts):
        memory = {}
        for p in parts:
            for d, s in zip(p.dst, p.src):
                memory[d.data_ptr()] = d.numpy().copy()
                memory[s.data_ptr()] = s.numpy().copy()
        self.real(plan, parts)
        if parts:
            self.rows += sum(len(p.slots) for p in parts)
            self._check(fleet.part_jobs(parts, plan.hosts), memory)


def _jobs_of(records, nj):
    return records[:nj * fleet.JOB.itemsize].view(fleet.JOB)


def drop_a_row(records, nj, n, memory):
    """One dirty row of the first job's rows section left out of the
    records (with its value in every job that shares the section), one
    whose value changes where there is one."""
    records = records.copy()
    table = _jobs_of(records, nj)
    at = int(table[0]["rows"])
    group = [j for j in range(nj) if int(table[j]["rows"]) == at]
    k = n if n >= 0 else int(table[0]["n"])
    rows = records[at:at + 4 * k].view(np.int32).copy()
    changed = []
    for i in range(k):
        for j in group:
            job, elem = table[j], int(table[j]["elem"])
            old = memory[int(job["src"] or job["dst"])].view(np.uint8).reshape(-1, elem)[rows[i]]
            new = records[int(job["vals"]) + elem * i: int(job["vals"]) + elem * (i + 1)]
            if not np.array_equal(old, new):
                changed.append(i)
                break
    drop = changed[0] if changed else 0
    keep = np.arange(k) != drop
    records[at:at + 4 * (k - 1)] = rows[keep].view(np.uint8)
    for j in group:
        job, elem = table[j], int(table[j]["elem"])
        vals = records[int(job["vals"]):int(job["vals"]) + elem * k].reshape(k, elem)[keep].copy()
        records[int(job["vals"]):int(job["vals"]) + elem * (k - 1)] = vals.ravel()
        if n < 0:
            table[j]["n"] = k - 1
    return records, (n - 1 if n >= 0 else n), bool(changed)


def shift_a_field(records, nj, n, memory):
    """The last job's values one row later."""
    records = records.copy()
    job = _jobs_of(records, nj)[nj - 1]
    k, elem = (n if n >= 0 else int(job["n"])), int(job["elem"])
    at = int(job["vals"])
    vals = records[at:at + elem * k].reshape(k, elem)
    shifted = np.roll(vals, 1, axis=0)
    detectable = not np.array_equal(shifted, vals)
    records[at:at + elem * k] = shifted.ravel()
    return records, n, detectable


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
    rec = Recorder(monkeypatch, replay_k6)

    def view(mirror):
        got = mirror.device_view(ALL_FIELDS)
        for name in ALL_FIELDS:
            assert np.array_equal(got[name].numpy(), getattr(mirror, name)), name

    mirror = _trace(seed, view)
    assert rec.views == rec.launches > 0 and rec.differed == 0
    assert mirror.cap >= 64 and mirror.full_uploads >= 2  # first use and growth
    assert mirror.plan_builds == mirror.full_uploads


@pytest.mark.parametrize("layout", ["1x1", "4x2", "2x4"])
@pytest.mark.parametrize("seed", [0, 1])
def test_k11_replay_equals_the_plain_version(seed, layout, monkeypatch):
    handed_out: set[int] = set()
    held = []  # every view handed out stays alive: no address is reused
    rec = Recorder(monkeypatch, lambda r, nj, n, m: replay_k11(r, nj, n, m, handed_out), kernel="k11")
    mesh = cpu_mesh(layout)

    def view(mirror):
        got = mirror.sharded_device_view(mesh, ALL_FIELDS)
        for name in ALL_FIELDS:
            assert np.array_equal(torch.cat(got[name]).numpy(), getattr(mirror, name)), name
        held.append(got)
        handed_out.update(b.data_ptr() for blocks in got.values() for b in blocks)

    mirror = _trace(seed, view)
    assert rec.views == rec.launches > 0 and rec.differed == 0
    assert mirror.plan_builds == mirror.full_uploads >= 2
    # the blocks every view handed out still hold their view's rows
    assert len({id(v[f][0]) for v in held for f in ALL_FIELDS}) > len(ALL_FIELDS)


@pytest.mark.parametrize("fault", [drop_a_row, shift_a_field], ids=["dropped_row", "shifted_field"])
@pytest.mark.parametrize("kernel", ["k6", "k11"])
def test_a_planted_fault_makes_the_replay_differ(kernel, fault, monkeypatch):
    rec = Recorder(monkeypatch, replay, fault, kernel)
    mesh = cpu_mesh("4x2")
    _trace(0, (lambda m: m.device_view(ALL_FIELDS)) if kernel == "k6"
           else (lambda m: m.sharded_device_view(mesh, ALL_FIELDS)))
    # every view whose fault changes a value is caught, and most do
    assert rec.differed == rec.detectable and rec.detectable >= rec.views // 2 > 0


@pytest.mark.parametrize("n_dirty", [0, 1, "cap"])
def test_dirty_counts_at_the_edges(n_dirty, monkeypatch):
    """0 dirty rows launch nothing; 1 and every slot of the capacity give
    one launch of one job a field, replayed equal to the plain version."""
    rec = Recorder(monkeypatch, replay_k6)
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
    assert rec.views == rec.launches == (n_dirty != 0) and rec.rows == len(pick) and rec.differed == 0
    for name in ALL_FIELDS:
        assert np.array_equal(view[name].numpy(), getattr(mirror, name))


def test_the_plans_fixed_layout_at_the_capacity():
    """The job table first, one rows section a group sized for the
    capacity, one values section a (group, field), each 16-byte aligned;
    every buffer of the ring holds the table from the start, and its numpy
    views write the buffer's own bytes."""
    dst = [torch.zeros(32, dtype=d) for d in (torch.int32, torch.float32, torch.bool, torch.int8)]
    hosts = [np.zeros(32, t) for t in (np.int32, np.float32, np.bool_, np.int8)]
    plan = fleet.ScatterPlan([dst], hosts, copy_on_write=False)
    assert plan.rows_at == [160]  # 4 jobs of 40 B, then one rows section of 32 int32
    assert plan.vals_at == [[288, 416, 544, 576]] and plan.nbytes == 608
    assert len(plan.slots) == fleet.RING_DEPTH
    for slot in plan.slots:
        table = slot.buf.numpy()[:160].view(fleet.JOB)
        assert list(table["dst"]) == [d.data_ptr() for d in dst] and not table["src"].any()
        assert list(table["elem"]) == [4, 4, 1, 1] and list(table["rows"]) == [160] * 4
        assert list(table["vals"]) == [288, 416, 544, 576] and not table["n_block"].any()
    slot = plan.slots[1]
    slot.rows[0][:3] = [3, 7, 31]
    slot.vals[0][1][:2] = [1.5, 2.5]
    raw = slot.buf.numpy()
    assert raw[160:172].view(np.int32).tolist() == [3, 7, 31]
    assert raw[416:424].view(np.float32).tolist() == [1.5, 2.5]
    # K11: a group a shard, the source block's length in every job
    blocks = [[torch.zeros(16, dtype=torch.int32), torch.zeros(16, dtype=torch.bool)] for _ in range(2)]
    plan = fleet.ScatterPlan(blocks, [np.zeros(32, np.int32), np.zeros(32, np.bool_)], copy_on_write=True)
    assert plan.rows_at == [160, 224] and plan.vals_at == [[288, 352], [368, 432]] and plan.nbytes == 448
    assert plan.template["n_block"].tolist() == [16] * 4 and not plan.template["dst"].any()


def test_the_plan_is_rebuilt_only_with_a_full_upload_or_pack(monkeypatch):
    """Each view's plans are rebuilt at first use, at growth, at a new field
    set and at a mesh not equal to the last one, and at no other time: the
    count of rebuilds equals the full uploads and packs, view by view."""
    Recorder(monkeypatch, replay_k6)
    state = pc.StandInState()
    mirror = state.mirror = TorchMirror(state, device="cpu")
    ws_list = [state.add_worker(f"tcp://plan:{i}", 2) for i in range(8)]
    rng = np.random.default_rng(12)
    log = []

    def step(what, view):
        before = (mirror.plan_builds, mirror.full_uploads)
        for ws in rng.choice(ws_list, 3, replace=False):
            _touch(state, ws, rng)
        view()
        log.append((what, mirror.plan_builds - before[0], mirror.full_uploads - before[1]))

    step("first use", lambda: mirror.device_view(DEVICE_FIELDS))
    step("dirty", lambda: mirror.device_view(DEVICE_FIELDS))
    step("a field less", lambda: mirror.device_view(DEVICE_FIELDS[:2]))
    step("a new field", lambda: mirror.device_view(("nbytes",)))
    ws_list += [state.add_worker(f"tcp://plan:{i}", 2) for i in range(8, 12)]
    step("growth", lambda: mirror.device_view(DEVICE_FIELDS))
    mesh = cpu_mesh("2x2")
    step("first mesh", lambda: mirror.sharded_device_view(mesh))
    step("dirty", lambda: mirror.sharded_device_view(mesh))
    step("an equal mesh", lambda: mirror.sharded_device_view(cpu_mesh("2x2")))
    step("a new mesh", lambda: mirror.sharded_device_view(cpu_mesh("1x4")))
    step("a new field", lambda: mirror.sharded_device_view(cpu_mesh("1x4"), ("idle",)))
    assert [(w, b) for w, b, _ in log] == [
        ("first use", 1), ("dirty", 0), ("a field less", 0), ("a new field", 1), ("growth", 1),
        ("first mesh", 1), ("dirty", 0), ("an equal mesh", 0), ("a new mesh", 1), ("a new field", 1)]
    assert all(b == f for _, b, f in log) and mirror.plan_builds == mirror.full_uploads == 6
    assert mirror.rows_uploaded > 0 and mirror.staging_waits == 0


@pytest.mark.parametrize("when", ["first_use", "growth"])
@pytest.mark.parametrize("kernel", ["k6", "k11"])
def test_a_failed_plan_build_raises_until_a_build_succeeds(kernel, when, monkeypatch):
    """A plan build that raises, at first use or at growth, takes the view's
    new tensors with it: the next view uploads or packs in full and builds
    again, and raises again while the build fails.  No view writes rows
    through the plain version or through a plan of the tensors it dropped;
    once a build succeeds, the views go through the new plan."""
    rec = Recorder(monkeypatch, replay_k6 if kernel == "k6" else (lambda r, nj, n, m: replay_k11(r, nj, n, m, set())),
                   kernel=kernel)

    def plain(jobs):
        raise AssertionError("a view off the CPU reached the plain version")

    monkeypatch.setattr(fleet, "scatter_rows_reference", plain)
    fails = {"n": 0}
    real_init = fleet.ScatterPlan.__init__

    def init(plan, *args, **kwargs):
        if fails["n"]:
            fails["n"] -= 1
            raise RuntimeError("the build failed")
        real_init(plan, *args, **kwargs)

    monkeypatch.setattr(fleet.ScatterPlan, "__init__", init)
    state = pc.StandInState()
    mirror = state.mirror = TorchMirror(state, device="cpu")
    ws_list = [state.add_worker(f"tcp://fail:{i}", 2) for i in range(8)]
    mesh = cpu_mesh("1x2")
    fields = ALL_FIELDS if kernel == "k6" else SHARDED_FIELDS

    def view():
        got = mirror.device_view(fields) if kernel == "k6" else mirror.sharded_device_view(mesh, fields)
        return {f: got[f] if kernel == "k6" else torch.cat(got[f]) for f in fields}

    rng = np.random.default_rng(13)
    if when == "growth":
        view()
        for ws in ws_list[:3]:
            _touch(state, ws, rng)
        view()
        assert rec.launches == 1 and mirror.plan_builds == 1
        ws_list += [state.add_worker(f"tcp://fail:{i}", 2) for i in range(8, 12)]
        assert mirror.cap == 16
    launches, builds, uploads = rec.launches, mirror.plan_builds, mirror.full_uploads
    fails["n"] = 2
    for _ in range(2):
        for ws in rng.choice(ws_list, 3, replace=False):
            _touch(state, ws, rng)
        with pytest.raises(RuntimeError, match="the build failed"):
            view()
    assert rec.launches == launches and mirror.plan_builds == builds and mirror.full_uploads == uploads + 2
    got = view()  # a full upload or pack, and its plan
    assert rec.launches == launches and mirror.plan_builds == builds + 1 and mirror.full_uploads == uploads + 3
    assert all(np.array_equal(got[f].numpy(), getattr(mirror, f)) for f in fields)
    for ws in rng.choice(ws_list, 3, replace=False):
        _touch(state, ws, rng)
    got = view()  # through the new plan
    assert rec.launches == launches + 1 and rec.differed == 0
    assert all(np.array_equal(got[f].numpy(), getattr(mirror, f)) for f in fields)


def test_the_plan_refuses_what_the_kernel_does_not_take():
    """The plan checks its tensors and host rows once; a view checks only
    its rows' range (and which kind of plan it was given)."""
    rows = np.array([0, 1], np.int32)
    ok, ok_host = torch.zeros(8, dtype=torch.int32), np.zeros(8, np.int32)
    with pytest.raises(ValueError, match="1 or 4 bytes"):
        fleet.ScatterPlan([[torch.zeros(8, dtype=torch.float64)]], [np.zeros(8)], copy_on_write=False)
    with pytest.raises(ValueError, match="contiguous 1-d"):
        fleet.ScatterPlan([[torch.zeros(16, dtype=torch.int32)[::2]]], [ok_host], copy_on_write=False)
    with pytest.raises(ValueError, match="contiguous 1-d"):
        fleet.ScatterPlan([[ok], [torch.zeros(4, dtype=torch.int32)]], [ok_host], copy_on_write=True)
    with pytest.raises(ValueError, match="differ in dtype"):
        fleet.ScatterPlan([[ok], [torch.zeros(8, dtype=torch.float32)]], [ok_host], copy_on_write=True)
    with pytest.raises(ValueError, match="host rows"):
        fleet.ScatterPlan([[ok]], [np.zeros(8, np.float32)], copy_on_write=False)
    plan = fleet.ScatterPlan([[ok]], [ok_host], copy_on_write=False)
    for bad in ([-1, 2], [0, 8], list(range(9))):
        with pytest.raises(ValueError, match="outside"):
            fleet.scatter_rows_cuda(plan, np.array(bad, np.int32))
    with pytest.raises(ValueError, match="in place"):
        fleet.scatter_blocks_cuda(plan, [fleet.Part(0, 0, rows, [ok], [ok])])
    cow = fleet.ScatterPlan([[ok]], [ok_host], copy_on_write=True)
    with pytest.raises(ValueError, match="copies on write"):
        fleet.scatter_rows_cuda(cow, rows)
    with pytest.raises(ValueError, match="outside"):
        fleet.scatter_blocks_cuda(cow, [fleet.Part(1, 0, rows, [ok], [ok])])
    for base, slots in ((0, rows + 7), (2, rows + 1), (0, np.arange(9))):  # past the host rows, before the base, too many
        with pytest.raises(ValueError, match="outside"):
            fleet.scatter_blocks_cuda(cow, [fleet.Part(0, base, slots, [ok], [ok])])
    assert all(not s.pending for s in plan.slots + cow.slots)  # nothing was acquired


def test_a_view_off_the_cpu_goes_to_the_kernel_and_never_the_plain_version(monkeypatch):
    """The CPU takes the plain version and never the build; a view on any
    other device goes through its plan to the kernel, which raises without
    CUDA, and never reaches the plain version."""
    def no_build():
        raise AssertionError("the CPU path built the kernels")

    monkeypatch.setattr(_build, "load", no_build)
    state = pc.StandInState()
    mirror = state.mirror = TorchMirror(state, device="cpu")
    ws_list = [state.add_worker(f"tcp://off:{i}", 2) for i in range(8)]
    launched = fleet.scatter_rows_cuda.launches
    mirror.device_view()
    mirror.sharded_device_view(cpu_mesh("1x2"))
    _touch(state, ws_list[3], np.random.default_rng(1))
    assert np.array_equal(mirror.device_view()["nthreads"].numpy(), mirror.nthreads)
    assert mirror.plan_builds == 0 and fleet.scatter_rows_cuda.launches == launched

    def plain(jobs):
        raise AssertionError("a view off the CPU reached the plain version")

    monkeypatch.setattr(fleet, "scatter_rows_reference", plain)
    state = pc.StandInState()
    mirror = state.mirror = TorchMirror(state, device="meta")
    ws_list = [state.add_worker(f"tcp://meta:{i}", 2) for i in range(8)]
    mirror.device_view()
    assert mirror.plan_builds == 1
    _touch(state, ws_list[3], np.random.default_rng(1))
    with pytest.raises(RuntimeError, match="needs CUDA"):
        mirror.device_view()
    block = torch.zeros(4, dtype=torch.int32, device="meta")
    cow = fleet.ScatterPlan([[block]], [np.zeros(4, np.int32)], copy_on_write=True)
    row = np.array([2], np.int32)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        fleet.scatter_blocks_cuda(cow, [fleet.Part(0, 0, row, [torch.empty_like(block)], [block])])


def test_cpu_views_equal_the_reference_mirrors(monkeypatch):
    """Every field of ``device_view`` and ``sharded_device_view`` on the
    CPU equals the reference mirror's host rows after the same churn, and
    the port's views went through the plain version's row writes."""
    calls = []
    real = fleet.scatter_rows_reference
    monkeypatch.setattr(fleet, "scatter_rows_reference", lambda jobs: (
        calls.append("k11" if jobs[0].src is not None else "k6"), real(jobs)))
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
    assert set(calls) == {"k6", "k11"} and port.mirror.rows_uploaded > 0
    assert port.mirror.plan_builds == 0
