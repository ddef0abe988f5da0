"""Graph partitioner: priority-order blocks + capped label propagation,
PyTorch + CUDA port.

The counterpart of ``distributed_tpu/ops/partition.py``, with its engine
mesh helpers (:func:`make_engine_mesh`, :func:`shard_bucket`).  The
scheduler's plan path sends every batch whose dense score
matrix fits (``_bucket(T) * lanes <= DENSE_LIMIT``) here instead of to the
leveled engine, so on a fleet of 1024 lanes every graph of up to 16,384
tasks is placed by this module, and on 16 lanes every graph of up to
1,048,576.

1. **Init: contiguous equal-load blocks of the priority order**
   (:func:`block_init`).  Scheduler priorities are depth-first graph
   order, so adjacent indices are related tasks.
2. **Refine: label propagation with a hard admission cap.**  Each round,
   every task scores every lane by the weight of its edges to tasks on
   that lane; lanes at or above ``cap`` times the average load are masked
   out as attractors; the current lane gets a stickiness bonus; the tasks
   whose index has the round's parity move to their best lane, all of
   them reading the round's old labels.

The refinement has two implementations with one contract, as the
reference's jitted ``run`` (``partition.py:271-289``) computes it:

- :func:`partition_reference`, the ``run`` body in torch ops, expression
  for expression (a dense ``[T, W]`` score matrix filled by two
  ``index_add_`` scatters in edge order, first-max ``argmax``);
- :func:`partition_cuda`, the hand-written kernel ``csrc/partition.cu``
  (K4): all rounds in one cooperative launch, each round a load phase and
  a rows phase between grid barriers.  It adds every score cell and every
  lane load in the reference's order, so it reproduces the plain version
  on the CPU bit for bit, whatever its grid.

:func:`partition_rounds` picks by the run's device: the plain version on
the CPU, the kernel anywhere else (which raises off CUDA).  The two
scalars the rounds read, the mean edge weight and the average lane load,
are computed once on the host by :func:`label_scalars`, in the order XLA
sums them on the CPU, so the port equals the reference bit for bit.

:func:`partition_numpy` is the reference's numpy engine, which the
scheduler runs when it is configured with ``partitioner="numpy"``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from distributed_tpu_torch._device import resolve_device
from distributed_tpu_torch.ops import _build

# scores matrix cap: T * W above this goes to the leveled engine
DENSE_LIMIT = 32_000_000
DEFAULT_ITERS = 8
DEFAULT_CAP = 1.2       # hard admission: load >= cap*avg cannot attract
DEFAULT_STICKY = 2.0    # current-label bonus, in units of mean edge weight
# csrc/partition.cu: up to this many lanes the kernel sums the lane loads
# by a counting sort, whose scratch holds a count per (block, lane) for up
# to BLOCKS_PER_SM blocks a multiprocessor (256 threads a block)
BUCKET_LANES = 64
BLOCKS_PER_SM = 8


def block_init(durations: np.ndarray, n_workers: int) -> np.ndarray:
    """Equal-load contiguous blocks over the (priority-sorted) task
    axis: label[i] = which of the W cumulative-duration buckets the
    midpoint of task i falls in."""
    T = len(durations)
    W = int(n_workers)
    if T == 0:
        return np.zeros(0, np.int64)
    d = np.asarray(durations, np.float64)
    cum = np.cumsum(d) - d / 2.0
    total = float(d.sum())
    if total <= 0:
        return (np.arange(T, dtype=np.int64) * W) // max(T, 1)
    return np.minimum((cum / total * W).astype(np.int64), W - 1)


def partition_numpy(
    durations: np.ndarray,    # f32[T] in PRIORITY order
    weights: np.ndarray,      # f32[E] cost of cutting edge e
    src: np.ndarray,          # i32[E] edge producer (task index)
    dst: np.ndarray,          # i32[E] edge consumer (task index)
    n_workers: int,
    iters: int = DEFAULT_ITERS,
    cap: float = DEFAULT_CAP,
    sticky: float = DEFAULT_STICKY,
    init: np.ndarray | None = None,
) -> np.ndarray:
    """The reference's numpy engine; returns i32[T] lane per task."""
    T = len(durations)
    W = int(n_workers)
    if T == 0 or W <= 1:
        return np.zeros(T, np.int32)
    labels = (
        init.astype(np.int64).copy() if init is not None
        else block_init(durations, W)
    )
    mean_w = float(weights.mean()) if len(weights) else 1.0
    avg_load = float(durations.sum()) / W or 1.0
    idx = np.arange(T)
    for it in range(iters):
        scores = np.zeros((T, W), np.float32)
        np.add.at(scores, (dst, labels[src]), weights)
        np.add.at(scores, (src, labels[dst]), weights)
        load = np.zeros(W, np.float32)
        np.add.at(load, labels, durations)
        blocked = load >= cap * avg_load
        scores = np.where(blocked[None, :], -np.inf, scores)
        own = np.maximum(scores[idx, labels], 0.0) + sticky * mean_w
        scores[idx, labels] = own
        new = np.argmax(scores, axis=1)
        labels = np.where((idx + it) % 2 == 0, new, labels)
    return labels.astype(np.int32)


def _bucket(n: int, floor: int = 1024) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def xla_row_sum(x: torch.Tensor) -> torch.Tensor:
    """Row sums of an f32 ``[R, n]`` matrix in the order XLA's CPU backend
    reduces a row: windows of 32 summed front to back (the row padded with
    zeros to a multiple of 32, half the padding in front), repeated until
    at most 32 values remain, which are summed front to back."""
    R = x.shape[0]
    while x.shape[1] > 32:
        pad = -x.shape[1] % 32
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2)).view(R, -1, 32)
        acc = torch.zeros(x.shape[:2], dtype=x.dtype, device=x.device)
        for j in range(32):
            acc = acc + x[:, :, j]
        x = acc
    total = torch.zeros(R, dtype=x.dtype, device=x.device)
    for j in range(x.shape[1]):
        total = total + x[:, j]
    return total


def xla_sum(x: np.ndarray) -> np.float32:
    """An f32 vector's sum in the order XLA's CPU backend adds it
    (:func:`xla_row_sum` of one row)."""
    row = torch.from_numpy(np.ascontiguousarray(x, np.float32))[None]
    return np.float32(xla_row_sum(row)[0].item())


def label_scalars(durations: np.ndarray, weights: np.ndarray,
                  n_lanes: int) -> tuple[np.float32, np.float32]:
    """``(mean_w, avg_load)`` as the reference's ``run`` computes them on
    its inputs padded to ``_bucket(T)`` tasks and ``_bucket(E)`` edges:
    the mean edge weight over the padded edges (0 with no edges) and
    ``max(sum(durations) / W, 1e-9)``.  The sums run over the padded
    vectors, whose length sets XLA's windows; XLA turns the divisions by
    constants into products with f32 reciprocals."""
    T, E = len(durations), len(weights)
    d = np.zeros(_bucket(T), np.float32)
    d[:T] = durations
    w = np.zeros(_bucket(max(E, 1)), np.float32)
    w[:E] = weights
    mean_w = xla_sum(w) * (np.float32(1.0) / np.float32(len(w)))
    avg_load = max(xla_sum(d) * (np.float32(1.0) / np.float32(n_lanes)),
                   np.float32(1e-9))
    return np.float32(mean_w), np.float32(avg_load)


class _Csr(NamedTuple):
    """A run's edges grouped by task, edge order kept in each group: the
    in-edges (by dst) give each edge's producer, the out-edges (by src)
    its consumer, each with the edge's weight."""

    in_off: torch.Tensor   # i32[T+1]
    in_nbr: torch.Tensor   # i32[E] producer of each in-edge
    in_w: torch.Tensor     # f32[E]
    out_off: torch.Tensor  # i32[T+1]
    out_nbr: torch.Tensor  # i32[E] consumer of each out-edge
    out_w: torch.Tensor    # f32[E]


class _Scratch(NamedTuple):
    """Work space of the kernel, allocated by the wrapper."""

    lab: tuple             # two i32[T] label buffers (the rounds alternate)
    blocked: torch.Tensor  # u8[W] the lane's load >= cap * avg_load
    cnt: torch.Tensor      # i32[cnt_blocks * W] per-block lane counts (W <= BUCKET_LANES)
    sorted: torch.Tensor   # f32[T] durations bucketed by lane (W <= BUCKET_LANES)
    cnt_blocks: int        # the largest grid cnt has room for


class PartitionRun:
    """One label propagation on one device: the graph, the initial labels,
    the two scalars, and the labels after the last round (``labels``, set
    by :func:`partition_rounds`).

    ``durations`` f32[T] in priority order, ``weights`` f32[E] and the
    edges ``src[e] -> dst[e]`` (task indices) over ``n_lanes`` lanes;
    ``init`` the labels before the first round (:func:`block_init` by
    default, as the reference's ``partition_jax``).  The scalars are
    :func:`label_scalars`'s, with the reference's ``cap`` and ``sticky``.
    """

    def __init__(self, durations, weights, src, dst, n_lanes: int,
                 iters: int = DEFAULT_ITERS, init=None, device=None):
        self.device = resolve_device(device)
        d = np.ascontiguousarray(durations, np.float32)
        w = np.ascontiguousarray(weights, np.float32)
        s = np.ascontiguousarray(src, np.int32)
        t = np.ascontiguousarray(dst, np.int32)
        T, E, W = len(d), len(w), int(n_lanes)
        if len(s) != E or len(t) != E:
            raise ValueError("weights, src and dst must have equal lengths")
        if W < 2:
            raise ValueError(f"label propagation needs at least 2 lanes, got {W}")
        if E and (min(s.min(), t.min()) < 0 or max(s.max(), t.max()) >= T):
            raise ValueError(f"edge endpoints must lie in [0, {T})")
        if init is None:
            init = block_init(d, W)
        init = np.ascontiguousarray(init, np.int32)
        if init.shape != (T,) or (T and (init.min() < 0 or init.max() >= W)):
            raise ValueError(f"init must hold {T} labels in [0, {W})")
        mean_w, avg_load = label_scalars(d, w, W)
        self.T, self.E, self.W, self.iters = T, E, W, int(iters)
        # the two products the rounds compare and add, in f32 as XLA
        # multiplies a weakly typed Python float by an f32 value
        self.thresh = float(np.float32(DEFAULT_CAP) * avg_load)
        self.bonus = float(np.float32(DEFAULT_STICKY) * mean_w)
        self.host = (d, w, s, t)

        def up(a):
            return torch.from_numpy(a).to(self.device)

        self.durations, self.weights, self.src, self.dst = (up(a) for a in self.host)
        self.init = up(init)
        self.labels: torch.Tensor = self.init
        self._csr: _Csr | None = None
        self._scratch: _Scratch | None = None

    def csr(self) -> _Csr:
        """The edges by task for the kernel, grouped once on the host
        (stable sorts) and uploaded at the first kernel call."""
        if self._csr is None:
            _, w, s, t = self.host

            def group(key, other):
                order = np.argsort(key, kind="stable")
                off = np.zeros(self.T + 1, np.int32)
                np.cumsum(np.bincount(key, minlength=self.T), out=off[1:])
                return (off, np.ascontiguousarray(other[order]),
                        np.ascontiguousarray(w[order]))

            arrays = (*group(t, s), *group(s, t))
            self._csr = _Csr(*(torch.from_numpy(a).to(self.device) for a in arrays))
        return self._csr

    def scratch(self) -> _Scratch:
        if self._scratch is None:
            T, W = self.T, self.W

            def new(n, dtype):
                return torch.empty(max(n, 1), dtype=dtype, device=self.device)

            buckets = W <= BUCKET_LANES
            cnt_blocks = (torch.cuda.get_device_properties(self.device).multi_processor_count
                          * BLOCKS_PER_SM if buckets else 0)
            self._scratch = _Scratch(
                lab=(new(T, torch.int32), new(T, torch.int32)), blocked=new(W, torch.uint8),
                cnt=new(cnt_blocks * W, torch.int32), sorted=new(T * buckets, torch.float32),
                cnt_blocks=cnt_blocks,
            )
        return self._scratch

    def result(self) -> np.ndarray:
        """The labels after the last round, i32[T] on the host."""
        return self.labels.cpu().numpy().astype(np.int32)


def partition_reference(run: PartitionRun) -> None:
    """The ``iters`` rounds in torch ops: the plain version of the kernel.

    The reference's ``run`` body expression for expression: a dense
    ``[T, W]`` score matrix filled by two sequential scatters over the
    edges (``index_add_`` on a flat view, in edge order on the CPU),
    lane loads by ``index_add_`` in task order, blocked lanes set to
    ``-inf`` before the current lane's bonus is written, the first
    maximum of each row, and the rows of the round's parity updated from
    the round's old labels.
    """
    T, W, dev = run.T, run.W, run.device
    f32 = dict(dtype=torch.float32, device=dev)
    thresh = torch.tensor(run.thresh, **f32)
    bonus = torch.tensor(run.bonus, **f32)
    src, dst = run.src.long(), run.dst.long()
    idx = torch.arange(T, device=dev)
    labels = run.init.long()
    for it in range(run.iters):
        scores = torch.zeros(T * W, **f32)
        scores.index_add_(0, dst * W + labels[src], run.weights)
        scores.index_add_(0, src * W + labels[dst], run.weights)
        scores = scores.view(T, W)
        load = torch.zeros(W, **f32).index_add_(0, labels, run.durations)
        scores.masked_fill_((load >= thresh)[None, :], float("-inf"))
        scores[idx, labels] = scores[idx, labels].clamp_min(0.0) + bonus
        new = torch.argmax(scores, dim=1)
        labels = torch.where((idx + it) % 2 == 0, new, labels)
    run.labels = labels.to(torch.int32)


def partition_cuda(run: PartitionRun, blocks: int | None = None, stamps=None) -> None:
    """The ``iters`` rounds through the hand-written kernel
    ``csrc/partition.cu``: one cooperative launch, ``blocks`` blocks (by
    default two a multiprocessor, never more than can be resident).  The
    labels do not depend on the grid.  ``partition_cuda.launches`` counts
    the launches; a run with no rounds or no tasks makes none.

    ``stamps``, an int64 CUDA tensor of ``2 * iters + 1``, receives the
    device clock (ns) at the start and after each round's load and rows
    phases (one more grid barrier than an untimed run).

    Up to ``BUCKET_LANES`` lanes the kernel sums the lane loads through a
    counting sort, whose scratch (a count per block and lane, the
    durations bucketed by lane) the run allocates at its first call.
    Shared memory grows with the lanes (4 B a lane for the score row, 1 B
    for the blocked flags); past what a block may opt into (the router
    sends at most DENSE_LIMIT / 1024 = 31,250 lanes, 185 KB) the launch is
    refused and this raises, as it does for a grid that cannot be resident
    at once."""
    if run.device.type != "cuda":
        raise RuntimeError(f"partition_cuda needs CUDA tensors, got {run.device}")
    T, E, W = run.T, run.E, run.W
    if blocks is not None and blocks < 1:
        raise ValueError(f"partition_cuda: blocks must be at least 1, got {blocks}")
    if run.iters == 0 or T == 0:
        run.labels = run.init
        return
    lib = _build.load()
    csr, sc = run.csr(), run.scratch()
    for name, t, dtype, n in (
        ("durations", run.durations, torch.float32, T), ("init", run.init, torch.int32, T),
        ("in_off", csr.in_off, torch.int32, T + 1), ("out_off", csr.out_off, torch.int32, T + 1),
        ("in_nbr", csr.in_nbr, torch.int32, E), ("out_nbr", csr.out_nbr, torch.int32, E),
        ("in_w", csr.in_w, torch.float32, E), ("out_w", csr.out_w, torch.float32, E),
        ("lab0", sc.lab[0], torch.int32, T), ("lab1", sc.lab[1], torch.int32, T),
        ("blocked", sc.blocked, torch.uint8, W),
        ("cnt", sc.cnt, torch.int32, sc.cnt_blocks * W),
        ("sorted", sc.sorted, torch.float32, T * (W <= BUCKET_LANES)),
        *((("stamps", stamps, torch.int64, 2 * run.iters + 1),) if stamps is not None else ()),
    ):
        if t.dtype != dtype or t.numel() < n or not t.is_contiguous() or t.device != run.device:
            raise ValueError(f"partition_cuda: {name} must be a contiguous {dtype}[{n}] on {run.device}")
    P = _build.ptr
    with torch.cuda.device(run.device):
        _build.check(lib.dtpu_partition(
            P(run.init), P(sc.lab[0]), P(sc.lab[1]), P(run.durations),
            P(csr.in_off), P(csr.in_nbr), P(csr.in_w), P(csr.out_off), P(csr.out_nbr),
            P(csr.out_w), P(sc.blocked), P(sc.cnt), P(sc.sorted),
            None if stamps is None else P(stamps), T, W, run.iters, run.thresh, run.bonus,
            blocks or 0, sc.cnt_blocks, _build.stream_handle(run.device),
        ), "dtpu_partition")
        partition_cuda.launches += 1
    run.labels = sc.lab[(run.iters - 1) % 2]


partition_cuda.launches = 0  # kernel launches in this process


def partition_rounds(run: PartitionRun) -> None:
    """The rounds on the run's device: the plain version for CPU tensors,
    the kernel otherwise (which raises off CUDA)."""
    if run.device.type == "cpu":
        partition_reference(run)
    else:
        partition_cuda(run)


def partition_padded(
    durations: np.ndarray,
    weights: np.ndarray,
    src: np.ndarray,
    dst: np.ndarray,
    n_workers: int,
    iters: int = DEFAULT_ITERS,
    device=None,
) -> np.ndarray:
    """i32[T] lane per task, as the reference's ``partition_padded``
    computes it: ``device=None`` means CUDA.

    The reference pads T and E to power-of-two buckets so that one jit
    compile serves graphs of similar size.  Its padding tasks (zero
    duration, labelled ``arange(TB - T) % W``) add 0 to lane loads and
    its padding edges (task 0 to itself, zero weight) add 0 to one score,
    so they change no real label and enter only the two scalars, which
    :func:`label_scalars` takes over the padded sizes.  The rounds here
    run on the real tasks and edges.
    """
    dev = resolve_device(device)
    T = len(durations)
    if T == 0 or int(n_workers) <= 1:
        return np.zeros(T, np.int32)
    run = PartitionRun(durations, weights, src, dst, n_workers, iters=iters, device=dev)
    partition_rounds(run)
    return run.result()


# ------------------------------------------------------------ engine mesh

#: axis names of the scheduler's engine mesh, in order: "tasks" is the
#: data-parallel wave axis, "workers" shards the fleet mirror's rows
ENGINE_AXES = ("tasks", "workers")


@dataclass(frozen=True)
class EngineMesh:
    """A ``(tasks, workers)`` grid of shards, the port's counterpart of the
    reference's ``jax.sharding.Mesh`` over :data:`ENGINE_AXES`.

    ``devices`` lists the shards' devices in the flattened row-major
    order: shard ``d`` sits at ``divmod(d, dw)`` and owns rows
    ``[d * Fl, (d + 1) * Fl)`` of every wave's window.  A device may
    appear more than once, so one card can hold several shards.  Meshes
    compare by value."""

    dt: int
    dw: int
    devices: tuple[torch.device, ...]

    axis_names = ENGINE_AXES

    def __post_init__(self):
        if self.dt < 1 or self.dw < 1 or len(self.devices) != self.dt * self.dw:
            raise ValueError(f"a {self.dt}x{self.dw} mesh needs {self.dt * self.dw} "
                             f"devices, got {len(self.devices)}")

    @property
    def shape(self) -> dict[str, int]:
        return {"tasks": self.dt, "workers": self.dw}

    @property
    def size(self) -> int:
        return self.dt * self.dw

    def workers_index(self, shard: int) -> int:
        """The ``workers``-axis coordinate of shard ``shard``."""
        return shard % self.dw


def make_engine_mesh(n_devices: int | None = None, layout: str = "auto",
                     devices=None) -> EngineMesh:
    """The scheduler co-processor mesh: 2-D ``(tasks, workers)``.

    ``layout`` is ``"auto"`` (factor the device count as close to square
    as possible, the workers axis the smaller factor) or ``"TxW"``, e.g.
    ``"4x2"``.  Without ``devices`` the mesh takes the visible CUDA
    devices (raising when there is none); ``n_devices`` of ``None``/``0``
    means all of them, and a larger count is cut to what exists.  An
    explicit ``devices`` list may repeat a device: that is how one card,
    or the CPU, holds several shards.  A layout that needs more devices
    than there are raises ``ValueError``, as the reference's does.
    """
    if devices is None:
        first = resolve_device(None)
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())] or [first]
    devices = [resolve_device(d) for d in devices]
    if n_devices:
        devices = devices[: min(int(n_devices), len(devices))]
    n = len(devices)
    if layout and layout != "auto":
        dt, dw = (int(p) for p in str(layout).lower().split("x"))
        if dt * dw > n:
            raise ValueError(f"layout {layout} needs {dt * dw} devices, have {n}")
        devices = devices[: dt * dw]
    else:
        if n == 0:
            raise ValueError("an engine mesh needs at least one device")
        dw = 1
        for f in range(int(np.sqrt(n)), 0, -1):
            if n % f == 0:
                dw = f
                break
        dt = n // dw
    return EngineMesh(dt, dw, tuple(devices))


def shard_bucket(n: int, n_shards: int, floor: int = 2048) -> int:
    """Per-shard power-of-two bucket for a wave of ``n`` tasks split over
    ``n_shards`` shards: every shard's slice has this one length."""
    need = max(-(-n // max(n_shards, 1)), 1)
    b = floor
    while b < need:
        b *= 2
    return b
