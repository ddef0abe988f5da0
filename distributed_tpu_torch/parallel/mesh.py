"""The placement co-processor over a mesh of shards, PyTorch port.

The counterpart of ``distributed_tpu/parallel/mesh.py``:

- :func:`make_mesh`: the ``(tasks, workers)`` mesh, the port's
  ``ops.partition.make_engine_mesh``;
- :func:`sharded_decide_workers`: the round-1 batched ``decide_worker``
  (parallel mode) on ``[B / dt, W / dw]`` cost tiles, one a shard, through
  the comm interface (``ops/comm.py``): each shard scores its rows against
  its workers, the any-holder and any-restricted flags are summed over the
  shards of its ``tasks`` row, and each row's winner is the least (cost,
  nbytes, global index) of the row's shards' bests;
- :func:`place_graph_leveled_sharded`: the sharded leveled engine
  (``ops/sharded.py``), in the reference's call shape.

The comm interface's ``psum`` sums over every shard, and this module needs
sums and gathers over the ``workers`` axis only.  So both go through one
``all_gather`` over the whole mesh, after which each shard reads its row's
``dw`` entries and adds or compares them in ``workers`` order, on every
comm the same (:func:`_row_gather`); the flags are int32, so the sums are
exact.  Torch has no ``lexsort``: the winner is a direct three-key
compare, the earliest shard winning a tie, as the reference's stable
``lexsort`` does.
"""

from __future__ import annotations

import torch

from distributed_tpu_torch.ops.comm import LocalShards
from distributed_tpu_torch.ops.partition import make_engine_mesh
from distributed_tpu_torch.ops.placement import (
    PlacementBatch,
    WorkerArrays,
    _segment_max,
    segment_sum_in_order,
)

INT32_MAX = 2**31 - 1


def make_mesh(n_devices: int | None = None, devices=None, layout: str = "auto"):
    """Factor the devices into a ``(tasks, workers)`` mesh, e.g. 8 -> 4x2
    (``ops.partition.make_engine_mesh``)."""
    return make_engine_mesh(n_devices, layout=layout, devices=devices)


def _row_gather(comm, mesh, parts):
    """Per shard this process holds, the ``[dw, ...]`` stack of its tasks
    row's shards' tensors, in ``workers`` order, on its device."""
    shape = parts[0].shape
    full = comm.all_gather([p.reshape(-1) for p in parts]).view(mesh.dt, mesh.dw, *shape)
    return [full[d // mesh.dw].to(mesh.devices[d]) for d in comm.local]


def sharded_decide_workers(mesh, workers: WorkerArrays, batch: PlacementBatch,
                           bandwidth: float, comm=None) -> torch.Tensor:
    """Batched ``decide_worker`` in parallel mode over ``mesh``: every task
    scored against the starting occupancy, each shard holding one
    ``[B / dt, W / dw]`` tile.  Equal to ``ops.placement.decide_workers(...,
    sequential=False)``'s assignment.  Returns the whole ``i32[B]``
    assignment on the first shard's device this process holds."""
    comm = comm or LocalShards(mesh)
    dt, dw = mesh.dt, mesh.dw
    B, W = len(batch.duration), len(workers.nthreads)
    if B % dt or W % dw:
        raise ValueError(f"a {dt}x{dw} mesh needs B ({B}) divisible by {dt} and W ({W}) by {dw}")
    if any(mesh.devices[d].type == "cuda" for d in comm.local):
        sharded_decide_workers.launches += 1
    Bl, Wl = B // dt, W // dw
    f32, i32 = torch.float32, torch.int32
    tiles = []
    for d in comm.local:
        ti, wi = divmod(d, dw)
        dev = mesh.devices[d]
        rows, cols = slice(ti * Bl, (ti + 1) * Bl), slice(wi * Wl, (wi + 1) * Wl)
        wk = WorkerArrays(*(x[cols] for x in workers.to(dev)))
        bt = batch.to(dev)
        restrict = (bt.restrict[rows, cols] if bt.restrict is not None
                    else torch.ones((Bl, Wl), dtype=torch.bool, device=dev))
        # this row range's edges: the reference clips the others onto the edge
        # rows with zero bytes and a zero holder flag, which changes no sum or max
        let = bt.edge_task.long() - ti * Bl
        in_range = (let >= 0) & (let < Bl)
        let, dep = let[in_range], bt.edge_dep.long()[in_range]
        has = bt.has[:, cols][dep]  # [E_row, Wl]
        missing = segment_sum_in_order(bt.dep_bytes[dep][:, None] * ~has, let, Bl)
        holder = _segment_max(has.to(i32), let, Bl) > 0
        holder &= wk.running[None, :]
        tiles.append((wk, bt.duration[rows], bt.valid[rows], restrict, missing, holder))
    any_holder = _row_gather(comm, mesh, [t[5].any(dim=1).to(i32) for t in tiles])
    restricted = []
    for (wk, _, _, restrict, _, holder), ah in zip(tiles, any_holder):
        cand = torch.where(ah.sum(dim=0, dtype=i32)[:, None] > 0, holder, wk.running[None, :])
        restricted.append(cand & restrict)
    any_restricted = _row_gather(comm, mesh, [r.any(dim=1).to(i32) for r in restricted])
    bests = []
    for d, (wk, _, valid, restrict, missing, _), r, ar in zip(comm.local, tiles, restricted,
                                                             any_restricted):
        cand = torch.where(ar.sum(dim=0, dtype=i32)[:, None] > 0, r,
                           restrict & wk.running[None, :])
        cand &= valid[:, None]
        thr = wk.nthreads.clamp(min=1).to(f32)
        cost = wk.occupancy[None, :] / thr[None, :] + missing / torch.tensor(
            bandwidth, dtype=f32, device=missing.device)
        inf = torch.tensor(float("inf"), dtype=f32, device=cost.device)
        big = torch.where(cand, cost, inf)
        best = big.amin(dim=1, keepdim=True)
        tied = (big == best) & cand
        nb = torch.where(tied, wk.nbytes[None, :], inf)
        best_nb = nb.amin(dim=1, keepdim=True)
        tied2 = tied & (nb == best_nb)
        gidx = torch.arange(Wl, dtype=i32, device=cost.device) + (d % dw) * Wl
        best_idx = torch.where(tied2, gidx[None, :], INT32_MAX).amin(dim=1)
        bests.append((best[:, 0], best_nb[:, 0], best_idx, valid))
    cs = _row_gather(comm, mesh, [b[0] for b in bests])
    nbs = _row_gather(comm, mesh, [b[1] for b in bests])
    idxs = _row_gather(comm, mesh, [b[2] for b in bests])
    picks = []
    for c, nb, ix, (_, _, _, valid) in zip(cs, nbs, idxs, bests):
        bc, bnb, bi = c[0], nb[0], ix[0]
        for s in range(1, dw):
            better = (c[s] < bc) | ((c[s] == bc) & ((nb[s] < bnb) | ((nb[s] == bnb) & (ix[s] < bi))))
            bc, bnb, bi = (torch.where(better, x[s], y) for x, y in ((c, bc), (nb, bnb), (ix, bi)))
        picks.append(torch.where(torch.isinf(bc) | ~valid, -1, bi).to(i32))
    # every shard of a tasks row holds the same picks: the rows in order
    return comm.all_gather(picks).view(dt, dw, Bl)[:, 0].reshape(B)


sharded_decide_workers.launches = 0  # calls on a CUDA mesh in this process: the route's launch count


def place_graph_leveled_sharded(mesh, packed, nthreads, occupancy0, running, axis: str = "tasks"):
    """The sharded leveled engine (``ops.sharded.place_graph_leveled_sharded``)
    in the reference's call shape: ``(assignment i32[T] in the original
    order, load f32[W])``.  ``axis`` is accepted for the reference's
    callers; the engine splits every wave over all of the mesh's shards."""
    from distributed_tpu_torch.ops.sharded import place_graph_leveled_sharded as engine

    res = engine(mesh, packed, nthreads, occupancy0, running)
    return res.assignment, res.occupancy
