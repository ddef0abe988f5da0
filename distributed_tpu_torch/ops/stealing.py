"""Batched work-stealing decisions, PyTorch + CUDA port.

The counterpart of ``distributed_tpu/ops/stealing.py``.  One balance cycle
of the scheduler's ``WorkStealing`` is K Jacobi rounds over SoA arrays;
in each round:

1. the unstolen tasks are ordered busiest victim first (by victim load
   ``occ / threads``), then by the steal key ``level << 27 | rank``;
2. the idle running thieves are ordered least loaded first, and slot r
   pairs the r-th task with the r-th thief;
3. each pair's criterion assumes every other same-victim candidate of the
   round already moved: ``others_cp`` is the sum of their compute;
4. ``vload[th] + tc + cp <= vload[vic] - others_cp / threads[vic] - cp/2``
   accepts a pair; accepted moves take compute off the victim and put
   compute + transfer on the thief, and a thief loaded past ``LATENCY``
   stops being idle.

The rounds have two implementations with one contract, the reference's
jitted ``_steal_rounds`` (``stealing.py:77-161``) as XLA computes it on
the CPU:

- :func:`steal_rounds_reference`, the rounds in torch ops, expression for
  expression (``jnp.lexsort`` as two stable sorts, last key first;
  ``others_cp`` as a ``[W, W]`` masked product summed in XLA's order,
  ``partition.xla_row_sum``; the two occupancy scatters as
  ``index_add_``, victims first, each in slot order);
- :func:`steal_rounds_cuda`, the hand-written kernel ``csrc/steal.cu``
  (K7): all rounds in one launch of one block.  A round finds only the
  first slots' tasks of the order (a radix select of the cut, then a
  sort of the tasks under it), and it sums in the same orders, so it
  reproduces the plain version on the CPU bit for bit.

:func:`steal_rounds` picks by the device of the tensors: the plain version
for CPU tensors, the kernel otherwise (which raises off CUDA).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from distributed_tpu_torch._device import resolve_device
from distributed_tpu_torch.ops import _build
from distributed_tpu_torch.ops.leveled import _bucket
from distributed_tpu_torch.ops.partition import xla_row_sum

LATENCY = 0.1  # assumed steal round-trip (reference stealing.py:33-37)

_RANK_BITS = 27  # key = level << 27 | rank; level < 16, rank < 2^27

IMAX = 2**31 - 1  # the key of a stolen task and of a padding row


class StealBatch(NamedTuple):
    """SoA view of one balance cycle's stealable tasks + worker fleet.

    The fleet arrays may be numpy arrays or tensors (the mirror's device
    view hands in tensors already on the card)."""

    task_victim: np.ndarray   # i32[T] worker index currently holding the task
    task_key: np.ndarray      # i32[T] (level << 27) | arrival-rank
    task_cost: np.ndarray     # f32[T] transfer seconds to a thief
    task_compute: np.ndarray  # f32[T] estimated compute seconds
    occ: np.ndarray           # f32[W] occupancy
    nthreads: np.ndarray      # i32[W]
    idle: np.ndarray          # bool[W] potential thieves
    running: np.ndarray       # bool[W]


def make_key(level: np.ndarray, rank: np.ndarray) -> np.ndarray:
    return (
        (level.astype(np.int32) << _RANK_BITS)
        | np.minimum(rank, (1 << _RANK_BITS) - 1).astype(np.int32)
    )


def steal_rounds_reference(task_victim, task_key, task_cost, task_compute,
                           occ, nthreads, idle, running, rounds: int):
    """The ``rounds`` Jacobi rounds in torch ops: the plain version of K7.
    Returns ``(thief_of i32[T], occ f32[W])``; the inputs are not changed."""
    T, W, dev = task_victim.shape[0], occ.shape[0], occ.device
    f32 = dict(dtype=torch.float32, device=dev)
    threads = nthreads.clamp_min(1).to(torch.float32)
    r = torch.arange(W, device=dev)
    latency = torch.tensor(LATENCY, **f32)
    inf = torch.tensor(float("inf"), **f32)
    victim = task_victim.long()
    occ, idle = occ.clone(), idle.clone()
    taken = torch.zeros(T, dtype=torch.bool, device=dev)
    thief_of = torch.full((T,), -1, dtype=torch.int32, device=dev)
    for _ in range(rounds):
        key = torch.where(taken, IMAX, task_key)
        vload = occ / threads
        usable = key != IMAX
        # jnp.lexsort((key, primary)): by the last key first, ties by index
        by_key = torch.argsort(key, stable=True)
        primary = torch.where(usable, -vload[victim], inf)
        order = by_key[torch.argsort(primary[by_key], stable=True)]
        thieves = idle & running
        thief_order = torch.argsort(torch.where(thieves, vload, inf), stable=True)
        n_th, n_usable = thieves.sum(), usable.sum()
        t = order[r.clamp_max(T - 1)]
        # r < n_usable: the double-steal guard (more thieves than tasks
        # would otherwise clamp several slots onto the last task)
        cand_ok = (r < n_th) & (r < n_usable) & usable[t]
        th = thief_order
        vic = victim[t]
        tc = torch.where(cand_ok, task_cost[t], 0.0)
        cp = torch.where(cand_ok, task_compute[t], 0.0)
        same = (vic[None, :] == vic[:, None]) & cand_ok[None, :] & cand_ok[:, None]
        others_cp = xla_row_sum(same * cp[None, :]) - cp
        crit = vload[th] + tc + cp <= vload[vic] - others_cp / threads[vic] - cp / 2
        acc = cand_ok & crit & (vic != th)
        # the victims' subtractions, then the thieves' adds, each in slot
        # order; index W takes the rejected slots and is dropped
        occ_x = torch.cat([occ, torch.zeros(1, **f32)])
        occ_x.index_add_(0, torch.where(acc, vic, W), -cp)
        occ_x.index_add_(0, torch.where(acc, th, W), cp + tc)
        occ = occ_x[:W]
        taken[t[acc]] = True
        thief_of[t[acc]] = th[acc].to(torch.int32)
        idle = idle & ~((occ / threads) > latency)
    return thief_of, occ


def steal_rounds_cuda(task_victim, task_key, task_cost, task_compute,
                      occ, nthreads, idle, running, rounds: int, stamps=None):
    """The rounds through the hand-written kernel ``csrc/steal.cu``: one
    launch of one block for all rounds.  Same arguments and results as
    :func:`steal_rounds_reference`; ``steal_rounds_cuda.launches`` counts
    the launches (none for a cycle without tasks or rounds).

    The block sorts in shared memory while the tasks and workers fit
    there, and in global scratch this wrapper allocates beyond that.

    ``stamps``, an int64 CUDA tensor of ``1 + rounds * len(STEAL_PHASES)``,
    receives the device clock (ns) at the start and at the end of each
    phase of each round (``profile_periodic.phase_split`` reads it); the
    results do not change."""
    dev = occ.device
    if dev.type != "cuda":
        raise RuntimeError(f"steal_rounds_cuda needs CUDA tensors, got {dev}")
    T, W = task_victim.shape[0], occ.shape[0]
    for name, t, dtype, n in (
        ("task_victim", task_victim, torch.int32, T), ("task_key", task_key, torch.int32, T),
        ("task_cost", task_cost, torch.float32, T), ("task_compute", task_compute, torch.float32, T),
        ("occ", occ, torch.float32, W), ("nthreads", nthreads, torch.int32, W),
        ("idle", idle, torch.bool, W), ("running", running, torch.bool, W),
    ):
        if t.dtype != dtype or t.shape != (n,) or t.device != dev:
            raise ValueError(f"steal_rounds_cuda: {name} must be {dtype}[{n}] on {dev}")
    n_stamps = 1 + max(rounds, 0) * len(STEAL_PHASES)
    if stamps is not None and (stamps.dtype != torch.int64 or stamps.shape != (n_stamps,)
                               or stamps.device != dev or not stamps.is_contiguous()):
        raise ValueError(f"steal_rounds_cuda: stamps must be a contiguous int64[{n_stamps}] on {dev}")
    occ_out = occ.contiguous().clone()
    thief_of = torch.full((T,), -1, dtype=torch.int32, device=dev)
    if T == 0 or W == 0 or rounds <= 0:
        return thief_of, occ_out
    lib = _build.load()
    with torch.cuda.device(dev):
        nbytes, in_smem = _layout(lib, T, W)
        scratch = torch.empty(0 if in_smem else nbytes, dtype=torch.uint8, device=dev)
        idle_w = idle.to(torch.uint8)  # the kernel retires thieves in it
        taken = torch.empty(T, dtype=torch.uint8, device=dev)
        P = _build.ptr
        _build.check(lib.dtpu_steal(
            P(task_victim.contiguous()), P(task_key.contiguous()), P(task_cost.contiguous()),
            P(task_compute.contiguous()), P(nthreads.contiguous()),
            P(running.contiguous()), P(occ_out), P(idle_w), P(thief_of), P(taken),
            None if in_smem else P(scratch), None if stamps is None else P(stamps),
            T, W, int(rounds), _build.stream_handle(dev),
        ), "dtpu_steal")
        steal_rounds_cuda.launches += 1
    return thief_of, occ_out


steal_rounds_cuda.launches = 0  # kernel launches in this process

# the phases of a round in K7's timeline, in order
STEAL_PHASES = ("keys", "tasks", "thieves", "slots", "sums", "criterion", "apply")


def _layout(lib, T: int, W: int) -> tuple[int, bool]:
    """(bytes, in shared memory) of K7's work space for T tasks, W workers."""
    nbytes, shared = ctypes.c_longlong(0), ctypes.c_int(0)
    _build.check(lib.dtpu_steal_layout(T, W, ctypes.byref(nbytes), ctypes.byref(shared)),
                 "dtpu_steal_layout")
    return int(nbytes.value), bool(shared.value)


def steal_rounds(task_victim, task_key, task_cost, task_compute, occ, nthreads,
                 idle, running, rounds: int):
    """The rounds on the tensors' device: the plain version for CPU
    tensors, K7 otherwise (which raises off CUDA)."""
    fn = steal_rounds_reference if occ.device.type == "cpu" else steal_rounds_cuda
    return fn(task_victim, task_key, task_cost, task_compute, occ, nthreads, idle,
              running, rounds)


def plan_steals(batch: StealBatch, rounds: int = 8, device=None) -> np.ndarray:
    """One balance cycle; returns the thief worker index per task (-1 = not
    stolen).  ``device=None`` means CUDA.

    The task arrays are padded to a power-of-two bucket (at least 64) as
    the reference pads them for its jit cache; the padding rows carry the
    sentinel key ``IMAX``, which is never nominated.  The bucket also sets
    how far the round's slots clamp into the task order, so the padding is
    kept rather than trimmed."""
    dev = resolve_device(device)
    T = len(batch.task_victim)
    if T == 0:
        return np.zeros(0, np.int32)
    W = len(batch.occ)
    victim = np.asarray(batch.task_victim)
    if victim.min() < 0 or victim.max() >= W:
        raise ValueError(f"task_victim must lie in [0, {W})")
    Tp = _bucket(T, floor=64)

    def pad(arr, fill, dtype):
        buf = np.full(Tp, fill, dtype)
        buf[:T] = arr
        return torch.from_numpy(buf).to(dev)

    def fleet(arr, dtype):
        return torch.as_tensor(arr).to(device=dev, dtype=dtype)

    thief_of, _ = steal_rounds(
        pad(victim, 0, np.int32), pad(batch.task_key, IMAX, np.int32),
        pad(batch.task_cost, 0, np.float32), pad(batch.task_compute, 0, np.float32),
        fleet(batch.occ, torch.float32), fleet(batch.nthreads, torch.int32),
        fleet(batch.idle, torch.bool), fleet(batch.running, torch.bool), rounds,
    )
    return thief_of[:T].cpu().numpy()
