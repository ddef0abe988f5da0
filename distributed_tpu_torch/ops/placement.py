"""Batched worker placement (round 1), PyTorch port.

The counterpart of ``distributed_tpu/ops/placement.py``: the scheduler's
``decide_worker`` objective as a dense ``[B, W]`` cost,

    cost[t, w] = occupancy[w] / nthreads[w] + missing[t, w] / bandwidth,

the candidates narrowed as ``decide_worker`` narrows them, and the argmin
taken in the lexicographic order (cost, worker nbytes, worker index).
``decide_workers(sequential=True)`` keeps the one-task-at-a-time semantics
(the reference's ``lax.scan``, here a loop over the batch, each step
vectorized over the workers); ``sequential=False`` is one argmin over the
whole matrix.  Torch ops, no hand kernel: none of this is on the product
scheduler's path.

Sums, as XLA's CPU backend adds them: ``missing`` adds each task's edges in
edge order (:func:`segment_sum_in_order`, exact on every device: a round
adds each task's next edge, so no two adds meet one element in a launch);
the occupancy sums of the parallel mode and :func:`occupancy_after_finish`
are ``index_add_``, in index order on the CPU, in the atomics' order on
CUDA (the card holds them to a tolerance, the assignments exactly).

Entry points take numpy arrays or tensors and run on ``device`` (CUDA for
None, raising without it; ``"cpu"`` for the plain run).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from distributed_tpu_torch._device import resolve_device

INT32_MIN = -(2 ** 31)


class WorkerArrays(NamedTuple):
    """SoA mirror of the scheduler's workers for one call."""

    nthreads: torch.Tensor  # i32[W]
    occupancy: torch.Tensor  # f32[W]
    nbytes: torch.Tensor  # f32[W]
    running: torch.Tensor  # bool[W]

    @property
    def nworkers(self) -> int:
        return self.nthreads.shape[0]

    def to(self, device) -> "WorkerArrays":
        return WorkerArrays(*(_as(x, device, dt) for x, dt in zip(self, _WORKER_DTYPES)))


class PlacementBatch(NamedTuple):
    """One batch of ready tasks to place."""

    duration: torch.Tensor  # f32[B]
    valid: torch.Tensor  # bool[B] padding mask
    edge_task: torch.Tensor  # i32[E] batch row per dependency edge
    edge_dep: torch.Tensor  # i32[E] dep-table slot per edge
    dep_bytes: torch.Tensor  # f32[D]
    has: torch.Tensor  # bool[D, W] replica matrix
    restrict: torch.Tensor | None = None  # bool[B, W] allowed workers, or None

    def to(self, device) -> "PlacementBatch":
        return PlacementBatch(*(None if x is None else _as(x, device, dt)
                                for x, dt in zip(self, _BATCH_DTYPES)))


_WORKER_DTYPES = (torch.int32, torch.float32, torch.float32, torch.bool)
_BATCH_DTYPES = (torch.float32, torch.bool, torch.int32, torch.int32, torch.float32,
                 torch.bool, torch.bool)


def _as(x, device, dtype):
    return torch.as_tensor(x, device=device).to(dtype)


def pad_to_bucket(n: int, buckets=(32, 128, 512, 2048, 8192, 32768)) -> int:
    """Round n up to a bucket (the reference's compile buckets)."""
    for b in buckets:
        if n <= b:
            return b
    b = buckets[-1]
    while b < n:
        b *= 2
    return b


def segment_sum_in_order(data: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """``out[s] = sum of data[i] over seg[i] == s``, each segment added in
    index order from zero (XLA's CPU scatter-add), on any device: round r
    adds each segment's r-th entry, every segment at most once a round.
    Entries that are zero throughout add nothing and are left out (a sum
    from +0.0 in round-to-nearest is never -0.0), so the batch's padding
    edges, all on row 0, cost no rounds."""
    out = torch.zeros((n, *data.shape[1:]), dtype=data.dtype, device=data.device)
    keep = data.ne(0).flatten(1).any(dim=1) if data.dim() > 1 else data.ne(0)
    data, seg = data[keep], seg.long()[keep]
    if seg.numel() == 0:
        return out
    order = torch.argsort(seg, stable=True)
    s = seg[order]
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    start = torch.cummax(torch.where(first, torch.arange(len(s), device=s.device), 0), 0)[0]
    rank = torch.arange(len(s), device=s.device) - start
    for r in range(int(rank.max()) + 1):
        sel = order[rank == r]
        out.index_add_(0, seg[sel], data[sel])
    return out


def missing_bytes_matrix(batch: PlacementBatch) -> torch.Tensor:
    """``missing[t, w]``: the bytes of t's dependencies that w lacks."""
    B = batch.duration.shape[0]
    not_has = ~batch.has[batch.edge_dep.long()]  # [E, W]
    contrib = batch.dep_bytes[batch.edge_dep.long()][:, None] * not_has
    return segment_sum_in_order(contrib, batch.edge_task, B)


def _segment_max(data: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_max``: empty segments hold INT32_MIN."""
    out = torch.full((n, *data.shape[1:]), INT32_MIN, dtype=data.dtype, device=data.device)
    idx = seg.long().view(-1, *([1] * (data.dim() - 1))).expand_as(data)
    return out.scatter_reduce_(0, idx, data, "amax")


def candidate_mask(batch: PlacementBatch, workers: WorkerArrays) -> torch.Tensor:
    """``cand[t, w]``: the dependency holders among the running workers,
    all running workers when none holds a dependency, intersected with the
    restrictions (falling back to the restricted running workers)."""
    B = batch.duration.shape[0]
    holder = _segment_max(batch.has[batch.edge_dep.long()].to(torch.int32), batch.edge_task,
                          B) > 0  # INT32_MIN where t has no edge
    running = workers.running[None, :]
    holder &= running
    cand = torch.where(holder.any(dim=1, keepdim=True), holder, running)
    if batch.restrict is not None:
        restricted = cand & batch.restrict
        cand = torch.where(restricted.any(dim=1, keepdim=True), restricted,
                           batch.restrict & running)
    return cand


def _ordered_cost(cost, wnbytes, valid):
    """Per row, the index of the least (cost, nbytes, index) among the
    valid entries, in three masked passes; ``W`` where none is valid."""
    big = cost.masked_fill(~valid, float("inf"))
    tied = (big == big.amin(dim=-1, keepdim=True)) & valid
    nb = wnbytes.expand(cost.shape).masked_fill(~tied, float("inf"))
    tied2 = tied & (nb == nb.amin(dim=-1, keepdim=True))
    W = cost.shape[-1]
    idx = torch.arange(W, dtype=torch.int32, device=cost.device)
    return torch.where(tied2, idx, W).amin(dim=-1).to(torch.int32)


def decide_workers(workers: WorkerArrays, batch: PlacementBatch, bandwidth: float,
                   sequential: bool = True, device=None):
    """Place a batch of ready tasks: ``(assignment i32[B], occupancy
    f32[W])``, -1 for a padding row or a task with no candidate.
    ``sequential=True``: task i sees the occupancy tasks 0..i-1 booked;
    ``sequential=False``: every task scored against the starting
    occupancy, then one occupancy sum."""
    dev = resolve_device(device)
    workers, batch = workers.to(dev), batch.to(dev)
    if dev.type == "cuda":
        decide_workers.launches += 1
    missing = missing_bytes_matrix(batch)
    cand = candidate_mask(batch, workers) & batch.valid[:, None]
    xfer = missing / torch.tensor(bandwidth, dtype=torch.float32, device=dev)
    nthreads = workers.nthreads.clamp(min=1).to(torch.float32)
    if not sequential:
        cost = workers.occupancy[None, :] / nthreads[None, :] + xfer
        assignment = _ordered_cost(cost, workers.nbytes[None, :], cand)
        assignment = torch.where(~cand.any(dim=1) | ~batch.valid, -1, assignment)
        a0 = assignment.clamp(min=0).long()
        delta = batch.duration + torch.gather(xfer, 1, a0[:, None])[:, 0]
        delta = torch.where(assignment >= 0, delta, 0.0)
        occ = workers.occupancy.clone().index_add_(0, a0, delta)
        return assignment, occ

    occ = workers.occupancy.clone()
    ok_all = cand.any(dim=1) & batch.valid
    nb = workers.nbytes[None, :]
    assignment = torch.empty(batch.duration.shape[0], dtype=torch.int32, device=dev)
    for t in range(assignment.shape[0]):
        cost = occ / nthreads + xfer[t]
        w = torch.where(ok_all[t], _ordered_cost(cost[None, :], nb, cand[t][None, :])[0], -1)
        w0 = w.clamp(min=0).long().view(1)
        delta = torch.where(ok_all[t], batch.duration[t] + xfer[t, w0], 0.0)
        occ.index_add_(0, w0, delta)
        assignment[t] = w
    return assignment, occ


decide_workers.launches = 0  # calls on a CUDA device in this process: the route's launch count


def place_rootish(n_tasks: int, workers: WorkerArrays, max_tasks: int = 0, device=None):
    """Contiguous blocks of a wave of ``n_tasks`` sibling tasks over the
    running workers, sized by their threads: ``i32[max_tasks]``, -1 past
    ``n_tasks`` or on a stopped worker."""
    dev = resolve_device(device)
    workers = workers.to(dev)
    if dev.type == "cuda":
        place_rootish.launches += 1
    W = workers.nworkers
    threads = torch.where(workers.running, workers.nthreads.clamp(min=1), 0).to(torch.int32)
    total = threads.sum(dtype=torch.int32).clamp(min=1)
    n = torch.tensor(n_tasks, dtype=torch.int32, device=dev)
    quota = (n * threads + total - 1) // total
    ends = torch.cumsum(quota, 0, dtype=torch.int32)
    t = torch.arange(max_tasks, dtype=torch.int32, device=dev)
    w_of_t = torch.searchsorted(ends, t, right=True).to(torch.int32).clamp(0, W - 1)
    valid = (t < n) & workers.running[w_of_t.long()]
    return torch.where(valid, w_of_t, -1)


place_rootish.launches = 0  # calls on a CUDA device in this process: the route's launch count


def occupancy_after_finish(occupancy, nthreads, finished_worker, finished_duration,
                           device=None) -> torch.Tensor:
    """The occupancy released by finished tasks (``-1`` worker: padding),
    floored at zero; raw seconds, not divided by threads."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        occupancy_after_finish.launches += 1
    occ = _as(occupancy, dev, torch.float32)
    fw = _as(finished_worker, dev, torch.int32)
    delta = torch.where(fw >= 0, _as(finished_duration, dev, torch.float32), 0.0)
    dec = torch.zeros_like(occ).index_add_(0, fw.clamp(min=0).long(), delta)
    return (occ - dec).clamp(min=0.0)


occupancy_after_finish.launches = 0  # calls on a CUDA device in this process


def build_batch_arrays(durations, edges, dep_bytes, has, restrict=None, bucket: bool = True,
                       device=None) -> PlacementBatch:
    """Host packing of a placement batch, padded to buckets as the
    reference pads it (padding edges point at a spare zero-byte dep slot),
    then moved to ``device``."""
    B = len(durations)
    Bp = pad_to_bucket(B) if bucket else B
    edge_task, edge_dep = edges
    E = len(edge_task)
    Ep = pad_to_bucket(max(E, 1)) if bucket else max(E, 1)
    D = len(dep_bytes)
    Dp = pad_to_bucket(D + 1) if bucket else D + 1
    W = has.shape[1] if has.ndim == 2 else 1
    dur = np.zeros(Bp, np.float32)
    dur[:B] = durations
    valid = np.zeros(Bp, bool)
    valid[:B] = True
    et = np.zeros(Ep, np.int32)
    ed = np.full(Ep, D, np.int32)
    et[:E] = edge_task
    ed[:E] = edge_dep
    db = np.zeros(Dp, np.float32)
    db[:D] = dep_bytes
    hs = np.zeros((Dp, W), bool)
    if has.size:
        hs[:D] = has
    rs = None
    if restrict is not None:
        rs = np.ones((Bp, W), bool)
        rs[:B] = restrict
    return PlacementBatch(dur, valid, et, ed, db, hs, rs).to(resolve_device(device))
