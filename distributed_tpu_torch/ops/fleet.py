"""The fleet mirror's row writes on the device (K6 and K11), PyTorch + CUDA port.

The reference's mirror (``distributed_tpu/scheduler/mirror.py``) keeps its
device views as jax arrays and writes a view's dirty rows with
``.at[rows].set`` (``_device_view``, ``mirror.py:356``, K6) or, on the
sharded engine's workers axis, into a new array a shard
(``_sharded_device_view``, ``mirror.py:428``, K11).  Here one view's writes
on one device are a list of :class:`Job`: write ``values`` at ``rows`` of
``dst``, in place (K6) or over a copy of the block ``src`` (K11,
copy-on-write: ``dst`` is a new tensor and ``src`` is never written).

Two implementations, one contract:

- :func:`scatter_rows_reference`, torch ops: a copy of the block, then
  ``index_copy_`` a job, on the tensors' device (the port's views before
  the kernel; the CPU tests, ``device="cpu"`` and chip_smoke.py's check);
- the hand-written kernel ``csrc/fleet_scatter.cu``: the jobs, their rows
  and values packed into one pinned record buffer (:func:`pack_records`),
  one launch for all the jobs of a view on a device, through
  :func:`scatter_rows_cuda` (K6, every job in place) or
  :func:`scatter_blocks_cuda` (K11, every job over a source block), each
  with its own launch count.  The record buffers come from a
  :class:`RecordRing`; the host waits for the card only when the ring
  comes round to a buffer whose launch has not run, and counts the wait.

:func:`scatter_rows` and :func:`scatter_blocks` pick by the device of the
tensors: the plain version for CPU tensors, the kernel otherwise (which
raises off CUDA).
"""

from __future__ import annotations

import struct
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
_JOB = struct.Struct("<QQiiiiii")  # JOB, packed field by field
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


def _up(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def layout(jobs: list[Job]) -> tuple[list[int], list[int], int]:
    """Byte offsets of each job's rows and values in the records, and the
    records' size.  Jobs that share one rows array (by identity) share its
    section."""
    at = _up(len(jobs) * JOB.itemsize)
    rows_at: dict[int, int] = {}
    rows_off, vals_off = [], []
    for job in jobs:
        key = id(job.rows)
        if key not in rows_at:
            rows_at[key] = at
            at = _up(at + 4 * len(job.rows))
        rows_off.append(rows_at[key])
    for job in jobs:
        vals_off.append(at)
        at = _up(at + job.values.nbytes)
    return rows_off, vals_off, at


def pack_records(jobs: list[Job], out: np.ndarray | None = None, plan=None) -> np.ndarray:
    """The record buffer csrc/fleet_scatter.cu reads: the job table, then
    the rows and the values, each section 16-byte aligned.  Written into
    ``out`` (a uint8 array at least that long) when given; ``plan`` is
    :func:`layout`'s result when the caller has it.  Returns the records'
    bytes."""
    rows_off, vals_off, size = layout(jobs) if plan is None else plan
    buf = np.zeros(size, np.uint8) if out is None else out[:size]
    written = set()
    for i, job in enumerate(jobs):
        src = job.src
        _JOB.pack_into(buf, i * JOB.itemsize, job.dst.data_ptr(), 0 if src is None else src.data_ptr(),
                       rows_off[i], vals_off[i], len(job.rows), 0 if src is None else src.shape[0],
                       job.values.dtype.itemsize, 0)
        if rows_off[i] not in written:
            written.add(rows_off[i])
            buf[rows_off[i]:rows_off[i] + 4 * len(job.rows)] = np.asarray(job.rows, np.int32).view(np.uint8)
        buf[vals_off[i]:vals_off[i] + job.values.nbytes] = np.ascontiguousarray(job.values).view(np.uint8)
    return buf


def check_jobs(jobs: list[Job]) -> torch.device:
    """The one device of the jobs' tensors; raises ``ValueError`` on a job
    the kernel does not take."""
    dev = jobs[0].dst.device
    rows_seen: dict[int, int] = {}  # a rows array's bound, checked once
    for job in jobs:
        dst, src = job.dst, job.src
        if dst.device != dev or dst.dim() != 1 or not dst.is_contiguous():
            raise ValueError(f"scatter_rows: destinations must be contiguous 1-d tensors on {dev}")
        if dst.dtype.itemsize not in ELEM_SIZES:
            raise ValueError(f"scatter_rows: {dst.dtype} is not 1 or 4 bytes")
        if src is not None and (src.shape != dst.shape or src.dtype != dst.dtype
                                or src.device != dev or not src.is_contiguous()):
            raise ValueError("scatter_rows: a source block must match its destination")
        if job.values.dtype.itemsize != dst.dtype.itemsize or len(job.values) != len(job.rows):
            raise ValueError("scatter_rows: one value of the destination's size a row")
        length = dst.shape[0]
        bound = rows_seen.get(id(job.rows))
        if bound is None:
            bound = rows_seen[id(job.rows)] = 0 if not len(job.rows) else (
                -1 if int(job.rows.min()) < 0 else int(job.rows.max()) + 1)
        if bound < 0 or bound > length:
            raise ValueError(f"scatter_rows: a row outside [0, {length})")
    return dev


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


class RecordRing:
    """Pinned record buffers for one CUDA device, used in turn, each with
    the event of the launch that read it and that launch's tensors (a K11
    source block may lose its last other reference before the launch
    runs); ``waits`` counts the times the host found the next buffer's
    launch not yet run and waited for it."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.bufs: list[torch.Tensor | None] = [None] * RING_DEPTH
        self.events: list[torch.cuda.Event | None] = [None] * RING_DEPTH  # made at a slot's first use
        self.held: list[list] = [[] for _ in range(RING_DEPTH)]
        self.i = 0
        self.waits = 0

    def acquire(self, nbytes: int) -> torch.Tensor:
        """The next pinned buffer, at least ``nbytes`` long, free to write."""
        ev = self.events[self.i]
        if ev is not None and not ev.query():
            ev.synchronize()
            self.waits += 1
        buf = self.bufs[self.i]
        if buf is None or buf.numel() < nbytes:
            size = max(nbytes, 4096, 0 if buf is None else 2 * buf.numel())
            buf = self.bufs[self.i] = torch.empty(size, dtype=torch.uint8, pin_memory=True)
        return buf

    def release(self, jobs: list[Job]) -> None:
        """Mark the buffer last acquired as read by the launch just made on
        ``jobs``, keeping their tensors until the buffer's next use."""
        if self.events[self.i] is None:
            self.events[self.i] = torch.cuda.Event()
        self.events[self.i].record(torch.cuda.current_stream(self.device))
        self.held[self.i] = jobs
        self.i = (self.i + 1) % len(self.bufs)


def _launch(jobs: list[Job], ring: RecordRing | None) -> None:
    """The jobs in one launch of ``csrc/fleet_scatter.cu`` on their device's
    current stream, the kernel reading the records from ``ring``'s next
    pinned buffer through its device address."""
    dev = check_jobs(jobs)
    if dev.type != "cuda" or ring is None or ring.device != dev:
        raise RuntimeError(f"the fleet kernel needs CUDA tensors on the ring's device, got {dev}")
    lib = _build.load()
    plan = layout(jobs)
    buf = ring.acquire(plan[2])
    # graft-lint: allow[launch-sync] the record buffer is pinned host memory; nothing is read from the card
    pack_records(jobs, buf.numpy(), plan)
    _build.check(_build.launch(dev, lib.dtpu_fleet_scatter, _build.ptr(buf), len(jobs)),
                 "dtpu_fleet_scatter")
    ring.release(jobs)


def scatter_rows_cuda(jobs: list[Job], ring: RecordRing) -> None:
    """K6: the jobs, each written in place, in one launch of the
    hand-written kernel (none for no job).  Same effect as
    :func:`scatter_rows_reference`; ``scatter_rows_cuda.launches`` counts
    the launches."""
    if not jobs:
        return
    if any(job.src is not None for job in jobs):
        raise ValueError("scatter_rows_cuda writes in place: a job has a source block")
    _launch(jobs, ring)
    scatter_rows_cuda.launches += 1


scatter_rows_cuda.launches = 0  # kernel launches in this process


def scatter_blocks_cuda(jobs: list[Job], ring: RecordRing) -> None:
    """K11: the jobs, each a new block filled from its source block and its
    rows, in one launch of the hand-written kernel (none for no job).  Same
    effect as :func:`scatter_rows_reference`;
    ``scatter_blocks_cuda.launches`` counts the launches."""
    if not jobs:
        return
    if any(job.src is None for job in jobs):
        raise ValueError("scatter_blocks_cuda copies on write: a job has no source block")
    _launch(jobs, ring)
    scatter_blocks_cuda.launches += 1


scatter_blocks_cuda.launches = 0  # kernel launches in this process


def scatter_rows(jobs: list[Job], ring: RecordRing | None = None) -> None:
    """K6's jobs on their tensors' device: the plain version for CPU
    tensors, the kernel otherwise (which raises off CUDA)."""
    if jobs and jobs[0].dst.device.type == "cpu":
        scatter_rows_reference(jobs)
    else:
        scatter_rows_cuda(jobs, ring)


def scatter_blocks(jobs: list[Job], ring: RecordRing | None = None) -> None:
    """K11's jobs on their tensors' device: the plain version for CPU
    tensors, the kernel otherwise (which raises off CUDA)."""
    if jobs and jobs[0].dst.device.type == "cpu":
        scatter_rows_reference(jobs)
    else:
        scatter_blocks_cuda(jobs, ring)
