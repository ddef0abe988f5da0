"""Whole-graph wavefront placement (round 1), PyTorch port.

The counterpart of ``distributed_tpu/ops/wavefront.py``: each wave places
every task whose dependencies are placed, in parallel, choosing between
the worker that produced its heaviest dependency (locality) and a
contiguous block over the least-loaded running workers (spreading), with
one Jacobi round against the wave's tentative load; the loop runs
``chunk_waves`` waves a call (a fixed trip: past the graph's end a wave
changes nothing) and the host checks progress between chunks, as the
reference's ``fori_loop`` chunks.  O(T + E + W) a wave, no ``[T, W]``
matrix.  Torch ops, no hand kernel: the product scheduler runs the leveled
engine (``ops/leveled.py``), not this one.

Sums: the wave's loads are ``index_add_`` over the ready tasks, in task
order on the CPU (XLA's CPU order), in the atomics' order on CUDA; the
indegree release is an int32 sum, exact anywhere.  ``jnp.argsort`` is
stable, so the load order is ``torch.argsort(stable=True)``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from distributed_tpu_torch._device import resolve_device

INT32_MAX = np.int32(2**31 - 1)


class GraphArrays(NamedTuple):
    """CSR-ish SoA encoding of a task graph for device placement."""

    duration: torch.Tensor  # f32[T] estimated runtime
    out_bytes: torch.Tensor  # f32[T] estimated output size
    indegree: torch.Tensor  # i32[T] number of dependencies
    heavy_dep: torch.Tensor  # i32[T] index of largest-bytes dep, -1 if none
    dep_bytes_total: torch.Tensor  # f32[T] sum of dep output bytes
    edge_src: torch.Tensor  # i32[E] producer task per dependency edge
    edge_dst: torch.Tensor  # i32[E] consumer task per dependency edge
    valid: torch.Tensor  # bool[T] padding mask

    @property
    def n(self) -> int:
        return self.duration.shape[0]

    @classmethod
    def from_arrays(cls, durations, out_bytes, edges_src, edges_dst, pad_tasks=None,
                    pad_edges=None, device=None) -> "GraphArrays":
        """Build from host numpy arrays (``edges_src[i] -> edges_dst[i]``:
        dst depends on src), padded as the reference pads, on ``device``
        (CUDA for None)."""
        T = len(durations)
        E = len(edges_src)
        Tp = pad_tasks or T
        Ep = pad_edges or max(E, 1)
        if Tp < T or Ep < E:
            raise ValueError(f"padding ({Tp}, {Ep}) below the graph ({T}, {E})")
        indeg = np.zeros(Tp, np.int32)
        np.add.at(indeg, edges_dst, 1)
        ob = np.zeros(Tp, np.float32)
        ob[:T] = out_bytes
        heavy = np.full(Tp, -1, np.int64)
        dep_total = np.zeros(Tp, np.float32)
        src_bytes = ob[edges_src]
        np.add.at(dep_total, edges_dst, src_bytes)
        # heaviest dependency per consumer: sort by (dst, -bytes, src), first wins
        if E:
            order = np.lexsort((edges_src, -src_bytes, edges_dst))
            dst_sorted = edges_dst[order]
            first = np.ones(E, bool)
            first[1:] = dst_sorted[1:] != dst_sorted[:-1]
            heavy[dst_sorted[first]] = edges_src[order][first]
        dur = np.zeros(Tp, np.float32)
        dur[:T] = durations
        valid = np.zeros(Tp, bool)
        valid[:T] = True
        indeg[T:] = INT32_MAX  # padding tasks never become ready
        es = np.zeros(Ep, np.int32)
        ed = np.zeros(Ep, np.int32)
        es[:E] = edges_src
        ed[:E] = edges_dst
        if Ep > E:
            # padding edges: a self-loop on a padding task (task 0 without one),
            # never fired, since padding tasks are never placed
            pad_t = T if Tp > T else 0
            es[E:] = pad_t
            ed[E:] = pad_t
        dev = resolve_device(device)
        return cls(*(torch.from_numpy(a).to(dev) for a in (
            dur, ob, indeg, heavy.astype(np.int32), dep_total, es, ed, valid)))


class PlacementResult(NamedTuple):
    assignment: torch.Tensor  # i32[T] worker per task (-1 = unplaced/pad)
    start_time: torch.Tensor  # f32[T] estimated start time
    occupancy: torch.Tensor  # f32[W] final modeled occupancy
    n_waves: torch.Tensor  # i32[] wavefront count (critical-path depth)
    wave_of: torch.Tensor  # i32[T] wave index each task was placed in (-1 = unplaced)


class _Carry(NamedTuple):
    assign: torch.Tensor  # i32[T]
    start: torch.Tensor  # f32[T]
    wave_of: torch.Tensor  # i32[T]
    indeg: torch.Tensor  # i32[T]
    load: torch.Tensor  # f32[W] cumulative work over all waves
    clock: torch.Tensor  # f32[] modeled wall clock at wave start
    wave: torch.Tensor  # i32[] waves that placed something


def _place_chunk(graph: GraphArrays, nthreads, occupancy0, running, c: _Carry,
                 bandwidth: float, chunk_waves: int) -> _Carry:
    """``chunk_waves`` waves (the reference's ``_place_chunk`` body, op for
    op); past the graph's end a wave changes nothing."""
    T = graph.n
    W = nthreads.shape[0]
    dev = nthreads.device
    f32, i32 = torch.float32, torch.int32
    threads_f = nthreads.clamp(min=1).to(f32)
    cap = torch.where(running, nthreads.clamp(min=1), 0).to(i32)
    inv_bw = torch.tensor(1.0 / bandwidth, dtype=f32, device=dev)
    inf = torch.tensor(float("inf"), dtype=f32, device=dev)
    hd = graph.heavy_dep.clamp(min=0).long()
    heavy_bytes = torch.where(graph.heavy_dep >= 0, graph.out_bytes[hd], 0.0)
    xfer_pref = (graph.dep_bytes_total - heavy_bytes) * inv_bw
    xfer_all = graph.dep_bytes_total * inv_bw
    w_run = (running & (cap > 0)).sum(dtype=i32).clamp(min=1).to(f32)
    src, dst = graph.edge_src.long(), graph.edge_dst.long()
    for _ in range(chunk_waves):
        ready = (c.indeg == 0) & (c.assign < 0) & graph.valid
        pref = torch.where(graph.heavy_dep >= 0, c.assign[hd], -1)
        p = pref.clamp(min=0).long()
        pref_ok = ready & (pref >= 0) & running[p]
        order = torch.argsort(torch.where(running, c.load / threads_f, inf), stable=True)
        n_ready = ready.sum(dtype=i32).clamp(min=1).to(f32)
        rank = (torch.cumsum(ready.to(i32), 0, dtype=i32) - 1).to(f32)
        slot = (rank * (w_run / n_ready)).to(i32).clamp(0, W - 1)
        spread = order[slot.long()]
        cost_pref = occupancy0[p] / threads_f[p] + xfer_pref
        cost_spread = occupancy0[spread] / threads_f[spread] + xfer_all
        choose_pref = pref_ok & (cost_pref <= cost_spread)
        # one Jacobi round against the wave's tentative load
        tent = torch.where(choose_pref, p, spread)
        tent_work = torch.where(ready, graph.duration + torch.where(choose_pref, xfer_pref, xfer_all),
                                0.0)
        tent_load = torch.zeros(W, dtype=f32, device=dev).index_add_(0, tent, tent_work)
        load_pref_others = tent_load[p] - torch.where(tent == p, tent_work, 0.0)
        load_spread_others = tent_load[spread] - torch.where(tent == spread, tent_work, 0.0)
        cost_pref2 = (occupancy0[p] + load_pref_others) / threads_f[p] + xfer_pref
        cost_spread2 = (occupancy0[spread] + load_spread_others) / threads_f[spread] + xfer_all
        choose_pref = pref_ok & (cost_pref2 <= cost_spread2)
        assign_wave = torch.where(choose_pref, pref, spread.to(i32))
        assign_wave = torch.where(ready & running[assign_wave.long()], assign_wave, -1)
        newly = assign_wave >= 0
        aw = assign_wave.clamp(min=0).long()
        xfer = torch.where(choose_pref, xfer_pref, xfer_all)
        work = torch.where(newly, graph.duration + xfer, 0.0)
        wave_load = torch.zeros(W, dtype=f32, device=dev).index_add_(0, aw, work)
        load = c.load + wave_load
        est_start = torch.where(newly, c.clock, 0.0)
        wave_span = torch.where(running, wave_load / threads_f, 0.0).amax()
        dec = torch.zeros(T, dtype=i32, device=dev).index_add_(0, dst, newly[src].to(i32))
        c = _Carry(
            assign=torch.where(newly, assign_wave, c.assign),
            start=torch.where(newly, est_start, c.start),
            wave_of=torch.where(newly, c.wave, c.wave_of),
            indeg=c.indeg - dec,
            load=load,
            clock=c.clock + wave_span,
            wave=c.wave + newly.any().to(i32),
        )
    return c


def place_graph(graph: GraphArrays, nthreads, occupancy0, running, bandwidth: float = 100e6,
                max_waves: int = 0, chunk_waves: int = 32) -> PlacementResult:
    """Schedule the whole graph on the graph's device: ``chunk_waves``
    waves a call, the host checking progress between calls (stopping when
    nothing is left, on a blocked graph, or at ``max_waves``)."""
    dev = graph.duration.device
    nthreads = torch.as_tensor(nthreads, device=dev).to(torch.int32)
    occupancy0 = torch.as_tensor(occupancy0, device=dev).to(torch.float32)
    running = torch.as_tensor(running, device=dev).to(torch.bool)
    if dev.type == "cuda":
        place_graph.launches += 1
    T = graph.n
    max_waves = max_waves or T
    carry = _Carry(
        assign=torch.full((T,), -1, dtype=torch.int32, device=dev),
        start=torch.zeros(T, dtype=torch.float32, device=dev),
        wave_of=torch.full((T,), -1, dtype=torch.int32, device=dev),
        indeg=graph.indegree,
        load=occupancy0,
        clock=torch.zeros((), dtype=torch.float32, device=dev),
        wave=torch.zeros((), dtype=torch.int32, device=dev),
    )
    waves_prev = 0
    while True:
        carry = _place_chunk(graph, nthreads, occupancy0, running, carry, bandwidth, chunk_waves)
        waves = int(carry.wave)
        if not bool(((carry.indeg == 0) & (carry.assign < 0) & graph.valid).any()):
            break
        if waves == waves_prev or waves >= max_waves:
            break  # a blocked graph (cycle, stopped workers) or the wave budget
        waves_prev = waves
    return PlacementResult(carry.assign, carry.start, carry.load, carry.wave, carry.wave_of)


place_graph.launches = 0  # calls on a CUDA device in this process: the route's launch count


def validate_placement(graph: GraphArrays, result: PlacementResult, running) -> None:
    """Host oracle: every valid task placed on a running worker, every
    consumer in a strictly later wave than its producers.  Raises
    ``AssertionError`` otherwise."""
    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    assign, valid, running = host(result.assignment), host(graph.valid), host(running)
    if not (assign[valid] >= 0).all():
        raise AssertionError("unplaced valid tasks")
    if not running[assign[valid]].all():
        raise AssertionError("task placed on non-running worker")
    src, dst, wave_of = host(graph.edge_src), host(graph.edge_dst), host(result.wave_of)
    real = valid[src] & valid[dst] & (src != dst)
    if not (wave_of[src[real]] >= 0).all():
        raise AssertionError("producer never placed")
    if not (wave_of[dst[real]] > wave_of[src[real]]).all():
        raise AssertionError("consumer placed no later than its producer")
