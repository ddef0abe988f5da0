"""The fleet mirror's row writes on the device (K6 and K11), PyTorch + CUDA port.

The reference's mirror (``distributed_tpu/scheduler/mirror.py``) keeps its
device views as jax arrays and writes a view's dirty rows with
``.at[rows].set`` (``_device_view``, ``mirror.py:356``, K6) or, on the
sharded engine's workers axis, into a new array a shard
(``_sharded_device_view``, ``mirror.py:428``, K11).

Two implementations, one contract:

- :func:`scatter_rows_reference`, torch ops on a list of :class:`Job`
  (write ``values`` at ``rows`` of ``dst``, over a copy of the block
  ``src`` when it is given): a copy of the block, then ``index_copy_`` a
  job, on the tensors' device.  The port's views before the kernel, the
  CPU's views (no plan is built there), the tests' form and chip_smoke.py's
  check;
  :func:`row_jobs` and :func:`part_jobs` give a planned view's jobs.
- the hand-written kernel ``csrc/fleet_scatter.cu``, one launch for all
  the writes of a view on a device, through a :class:`ScatterPlan`: the
  tensors, their host rows and the record layout, checked and laid out
  once (the mirror rebuilds its plan exactly when it uploads or packs in
  full), with a ring of pinned record buffers whose job tables, device
  addresses and numpy views are made once.  A view only copies its rows
  into the next buffer, gathers each field's values there
  (``ndarray.take(..., out=)``) and launches: :func:`scatter_rows_cuda` (K6,
  every field written in place, the row count an argument of the launch)
  or :func:`scatter_blocks_cuda` (K11, a new block a dirty (shard, field)
  filled from its source block and its rows), each with its own launch
  count.  The kernel's last block stores the buffer's launch number into
  mapped host memory, so the host reuses a buffer without asking the
  driver (a CUDA event a buffer, queried through the runtime, cost each
  view 3-6 µs more of host time on an NVIDIA H100 80GB HBM3 at 700 W:
  PERF.md), and waits
  (:attr:`ScatterPlan.waits`) only when the ring comes round to a launch
  that has not run.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import NamedTuple

import numpy as np
import torch

from distributed_tpu_torch.ops import _build

#: one job of the record buffer (csrc/fleet_scatter.cu's Job): device
#: addresses of the destination and the source block (0: in place), byte
#: offsets of the rows and values in the records, the row count, the
#: block's length and the element size
JOB = np.dtype([("dst", "<u8"), ("src", "<u8"), ("rows", "<i4"), ("vals", "<i4"),
                ("n", "<i4"), ("n_block", "<i4"), ("elem", "<i4"), ("pad", "<i4")])
ALIGN = 16
#: element sizes the kernel copies (bool, int8; int32, float32)
ELEM_SIZES = (1, 4)
#: record buffers in a ring: the host waits only when it comes round to
#: one whose launch has not run yet
RING_DEPTH = 4


class Job(NamedTuple):
    """Write ``values[i]`` at ``dst[rows[i]]``, over a copy of ``src``
    when it is given (``dst`` and ``src`` of one shape and dtype)."""

    dst: torch.Tensor
    src: torch.Tensor | None
    rows: np.ndarray    # int32, distinct indices into dst
    values: np.ndarray  # dst's dtype, one a row


class Part(NamedTuple):
    """One dirty block of a K11 view: group ``g`` of the plan, the slot of
    the block's first row in the host fields (``base``), the dirty slots
    (ascending; row ``slot - base`` of the block), and a new block a field
    (``dst``) filled from the field's current block (``src``), in the
    plan's field order."""

    g: int
    base: int
    slots: np.ndarray
    dst: list
    src: list


def scatter_rows_reference(jobs: list[Job]) -> None:
    """The plain version in torch ops on the tensors' device: each job's
    block copied into its destination, then its rows by ``index_copy_``."""
    for job in jobs:
        dev = job.dst.device
        if job.src is not None:
            job.dst.copy_(job.src)
        if len(job.rows):
            idx = torch.from_numpy(np.asarray(job.rows, np.int64)).to(dev)
            job.dst.index_copy_(0, idx, torch.from_numpy(np.ascontiguousarray(job.values)).to(dev))


def row_jobs(tensors: list[torch.Tensor], hosts: list[np.ndarray], rows: np.ndarray) -> list[Job]:
    """K6's view as jobs: each field's tensor written in place at ``rows``
    with its host values there."""
    return [Job(t, None, rows, host[rows]) for t, host in zip(tensors, hosts)]


def part_jobs(parts: list[Part], hosts: list[np.ndarray]) -> list[Job]:
    """K11's view as jobs: each part's new blocks over their source blocks
    at the part's rows, with the host values of its slots."""
    out = []
    for p in parts:
        rows = (p.slots - p.base).astype(np.int32)
        out += [Job(d, s, rows, host[p.slots]) for d, s, host in zip(p.dst, p.src, hosts)]
    return out


def _up(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


class _Slot:
    """One record buffer of a plan's ring and the numpy views into it."""

    __slots__ = ("buf", "addr", "words", "n_col", "rows", "vals", "groups", "seq", "blocks", "pending", "held")

    def __init__(self, plan: "ScatterPlan", pinned: bool):
        self.buf = torch.empty(plan.nbytes, dtype=torch.uint8, pin_memory=pinned)
        arr = self.buf.numpy()
        table = arr[:plan.n_jobs * JOB.itemsize]
        # the job table as 8-byte words (dst, src, offsets, counts, sizes)
        # and its row counts, written by column
        self.words = table.view(np.uint64).reshape(plan.n_jobs, JOB.itemsize // 8)
        self.n_col = table.view(np.int32).reshape(plan.n_jobs, JOB.itemsize // 4)[:, JOB.fields["n"][1] // 4]
        self.rows = [arr[at:at + 4 * plan.per].view(np.int32) for at in plan.rows_at]
        self.vals = [[arr[at:at + plan.per * dt.itemsize].view(dt) for at, dt in zip(ats, plan.dtypes)]
                     for ats in plan.vals_at]
        self.words[:] = plan.template.view(np.uint64).reshape(self.words.shape)
        self.groups = tuple(range(plan.G))  # the groups whose jobs the table holds, in order
        self.addr = plan._device_address(self.buf) if pinned else self.buf.data_ptr()
        self.seq = 0         # launches that read this buffer
        self.blocks = 0      # blocks of those launches: the count the kernel's last block meets
        self.pending = False
        self.held = None     # a K11 launch's parts: their source blocks live until the buffer's reuse


class ScatterPlan:
    """The record layout of one device's views, made once.

    ``groups[g][f]`` is field ``f``'s tensor of group ``g`` (K6: one group,
    the capacity-sized fields, written in place; K11, ``copy_on_write``:
    one group a shard on this device, each a shard's block), all 1-d,
    contiguous, of one length ``per`` and on one device, field ``f`` of
    one dtype of 1 or 4 bytes in every group; ``hosts[f]`` is field
    ``f``'s host rows, of that dtype, from which a view gathers its values.
    Checked here and never again: a view checks only its rows' range.

    The records: a job table of one 40 B job a (group, field), then a rows
    section of ``per`` int32 a group, then a values section of ``per``
    elements a (group, field), each 16-byte aligned.  Each of the ring's
    ``RING_DEPTH`` buffers holds the table written once (K6: complete;
    K11: a view rewrites the rows of its dirty groups' jobs, their new
    blocks and their source blocks) and keeps its device address, taken
    once.  ``waits`` counts the views that found the next buffer's launch
    not yet run."""

    def __init__(self, groups: list[list[torch.Tensor]], hosts: list[np.ndarray], copy_on_write: bool):
        first = groups[0][0]
        self.device = first.device
        self.copy_on_write = copy_on_write
        self.groups = [list(g) for g in groups]
        self.hosts = list(hosts)
        self.G, self.F, self.per = len(groups), len(hosts), int(first.shape[0])
        self.dtypes = [_numpy_dtype(t.dtype) for t in groups[0]]
        for g in groups:
            if len(g) != self.F:
                raise ValueError(f"ScatterPlan: a group of {len(g)} fields, not {self.F}")
            for t, dt in zip(g, self.dtypes):
                if t.device != self.device or t.dim() != 1 or t.shape[0] != self.per or not t.is_contiguous():
                    raise ValueError(f"ScatterPlan: blocks must be contiguous 1-d tensors of {self.per} on "
                                     f"{self.device}")
                if _numpy_dtype(t.dtype) != dt:
                    raise ValueError("ScatterPlan: a field's blocks differ in dtype")
        for dt, host in zip(self.dtypes, self.hosts):
            if dt.itemsize not in ELEM_SIZES:
                raise ValueError(f"ScatterPlan: {dt} is not 1 or 4 bytes")
            if host.dtype != dt or host.ndim != 1 or not host.flags.c_contiguous:
                raise ValueError(f"ScatterPlan: a field's host rows must be a contiguous 1-d {dt} array")
        self.n_jobs = self.G * self.F
        at = _up(self.n_jobs * JOB.itemsize)
        self.rows_at = []
        for _ in range(self.G):
            self.rows_at.append(at)
            at = _up(at + 4 * self.per)
        self.vals_at = []
        for _ in range(self.G):
            row = []
            for dt in self.dtypes:
                row.append(at)
                at = _up(at + self.per * dt.itemsize)
            self.vals_at.append(row)
        self.nbytes = at
        t = self.template = np.zeros(self.n_jobs, JOB)
        t["rows"] = np.repeat(self.rows_at, self.F)
        t["vals"] = np.ravel(self.vals_at)
        t["elem"] = np.tile([dt.itemsize for dt in self.dtypes], self.G)
        t["n_block"] = self.per if copy_on_write else 0
        if not copy_on_write:
            t["dst"] = [b.data_ptr() for g in groups for b in g]
        self.words = t.view(np.uint64).reshape(self.n_jobs, JOB.itemsize // 8)
        pinned = self.device.type == "cuda"
        self._lib = _build.load() if pinned else None
        self._flags = self._flag_addr = self._count_addr = None
        if pinned:
            # each buffer's completion: the launch number its kernel's last
            # block stores in mapped host memory, and the blocks' count
            self._flag_buf = torch.zeros(RING_DEPTH, dtype=torch.int64, pin_memory=True)
            self._flags = self._flag_buf.numpy()
            self._flag_addr = self._device_address(self._flag_buf)
            self._counts = torch.zeros(RING_DEPTH, dtype=torch.int64, device=self.device)
            self._count_addr = self._counts.data_ptr()
        self.slots = [_Slot(self, pinned) for _ in range(RING_DEPTH)]
        self.i = 0
        self.waits = 0
        if pinned:
            # a dropped plan's buffers (and K11's held blocks) stay until
            # their launches have run: a pinned buffer freed under a launch
            # not yet run could be handed out and written again
            weakref.finalize(self, _settle, self.slots, self._flags, self.device).atexit = False

    def _device_address(self, buf: torch.Tensor) -> int:
        """The device address of pinned ``buf`` (cudaHostGetDevicePointer, once)."""
        out = ctypes.c_void_p()
        _build.check(self._lib.dtpu_fleet_device_address(buf.data_ptr(), ctypes.byref(out)),
                     "dtpu_fleet_device_address")
        return out.value

    def acquire(self) -> _Slot:
        """The next record buffer, free to write: its last launch has run
        (the host waits for it, and counts the wait, only if it has not)."""
        slot = self.slots[self.i]
        if slot.pending:
            k = self.i
            if self._flags[k] < slot.seq:
                self._wait(slot, k)
                self.waits += 1
            slot.pending = False
            slot.held = None
        return slot

    def _wait(self, slot: _Slot, k: int) -> None:
        # the whole card: a wait is rare (the ring came round to a launch
        # not yet run), and the card then has at most the ring's launches
        # and what was enqueued after them to run
        torch.cuda.synchronize(self.device)
        if self._flags[k] < slot.seq:
            raise RuntimeError(f"fleet ring slot {k}: launch {slot.seq} ran without storing its number")

    def launch(self, slot: _Slot, nj: int, n: int) -> None:
        """One launch of the kernel over ``slot``'s first ``nj`` jobs (``n``
        rows each, or each job's own count when ``n`` is -1) on the
        device's current stream; the ring moves on."""
        if self.device.type != "cuda":
            raise RuntimeError(f"the fleet kernel needs CUDA tensors, got {self.device}")
        k = self.i
        seq, blocks = slot.seq + 1, slot.blocks + nj
        _build.check(_build.launch(self.device, self._lib.dtpu_fleet_scatter, slot.addr, nj, n,
                                   self._flag_addr + 8 * k, seq, self._count_addr + 8 * k, blocks),
                     "dtpu_fleet_scatter")
        slot.seq, slot.blocks, slot.pending = seq, blocks, True
        self.i = (k + 1) % RING_DEPTH


def _settle(slots: list[_Slot], flags: np.ndarray, device: torch.device) -> None:
    """Wait for the launches of ``slots`` that have not run (a plan being
    dropped)."""
    if any(slot.pending and flags[k] < slot.seq for k, slot in enumerate(slots)):
        torch.cuda.synchronize(device)


def launch_empty(device) -> None:
    """One launch of the fleet kernel with no job on ``device``'s current
    stream, through a view's own launch path: the floor of a view."""
    dev = torch.device(device)
    _build.check(_build.launch(dev, _build.load().dtpu_fleet_scatter, None, 0, 0, None, 0, None, 0),
                 "dtpu_fleet_scatter")


def _in_range(rows: np.ndarray, bound: int) -> bool:
    return len(rows) <= bound and int(rows[0]) >= 0 and int(rows[-1]) < bound


def _counted(launch):
    """``launch`` with a count of the launches it made (those calls that
    returned True) on the returned function's ``launches``; the count
    stays on it while the module's name is rebound to a wrapper."""

    @functools.wraps(launch)
    def counted(*args):
        if launch(*args):
            counted.launches += 1

    counted.launches = 0  # kernel launches in this process
    return counted


@_counted
def scatter_rows_cuda(plan: ScatterPlan, rows: np.ndarray) -> bool:
    """K6: the plan's one group written in place at ``rows`` (ascending,
    distinct; ``intp`` gathers fastest) with their host values, in one
    launch of the hand-written kernel (none for no row).  Same effect as
    :func:`scatter_rows_reference` on :func:`row_jobs`;
    ``scatter_rows_cuda.launches`` counts the launches."""
    n = len(rows)
    if not n:
        return False
    if plan.copy_on_write:
        raise ValueError("scatter_rows_cuda writes in place: the plan copies on write")
    if not _in_range(rows, plan.per):
        raise ValueError(f"scatter_rows_cuda: a row outside [0, {plan.per})")
    slot = plan.acquire()
    slot.rows[0][:n] = rows
    for host, out in zip(plan.hosts, slot.vals[0]):
        host.take(rows, out=out[:n], mode="clip")  # in range: checked above
    plan.launch(slot, plan.F, n)
    return True


@_counted
def scatter_blocks_cuda(plan: ScatterPlan, parts: list[Part]) -> bool:
    """K11: each part's new blocks filled from their source blocks and the
    part's rows with their host values, in one launch of the hand-written
    kernel (none for no part).  Same effect as
    :func:`scatter_rows_reference` on :func:`part_jobs`;
    ``scatter_blocks_cuda.launches`` counts the launches."""
    if not parts:
        return False
    if not plan.copy_on_write:
        raise ValueError("scatter_blocks_cuda copies on write: the plan writes in place")
    n_host, F = len(plan.hosts[0]), plan.F
    for p in parts:
        lo, hi = int(p.slots[0]), int(p.slots[-1])
        if not (0 <= p.g < plan.G and len(p.dst) == len(p.src) == F and len(p.slots) <= plan.per
                and 0 <= p.base <= lo and hi < min(p.base + plan.per, n_host)):
            raise ValueError(f"scatter_blocks_cuda: a part outside the plan's {plan.G} groups of {plan.per} rows")
    slot = plan.acquire()
    k = len(parts) * F
    gs = tuple(p.g for p in parts)
    if gs != slot.groups[:len(gs)]:  # other groups than the table holds: their jobs from the template
        slot.words[:k] = plan.words[[g * F + f for g in gs for f in range(F)]]
        slot.groups = gs
    dst, src = [], []
    for i, p in enumerate(parts):
        n = len(p.slots)
        dst += [d.data_ptr() for d in p.dst]
        src += [s.data_ptr() for s in p.src]
        slot.n_col[i * F:(i + 1) * F] = n
        np.subtract(p.slots, p.base, out=slot.rows[p.g][:n], casting="unsafe")
        for host, out in zip(plan.hosts, slot.vals[p.g]):
            host.take(p.slots, out=out[:n], mode="clip")
    slot.words[:k, 0] = dst
    slot.words[:k, 1] = src
    plan.launch(slot, k, -1)
    slot.held = parts
    return True
