"""Batched Active-Memory-Manager replica-drop selection, PyTorch + CUDA
port.

The counterpart of ``distributed_tpu/ops/amm.py``.  Given the (task x
worker) replica matrix of one AMM round, K Jacobi rounds peel excess
replicas off the fullest holders; in each round:

1. every task still asked to drop (``ndrop > 0``) and holding more than
   one replica drops from its eligible holder (a holder not in active
   use) with the highest projected memory, the first such holder on ties
   (``argmax`` over a score row that is ``-inf`` off the eligible
   holders; a row with no eligible holder drops nothing);
2. each worker's projected memory shrinks by the bytes dropped from it,
   summed in row order, and is floored at 0.

The rounds have two implementations with one contract, the reference's
jitted ``_drop_rounds`` (``amm.py:43-74``) as XLA computes it on the CPU:

- :func:`drop_rounds_reference`, the rounds in torch ops, expression for
  expression (the ``segment_sum`` as ``index_add_`` in row order);
- :func:`drop_rounds_cuda`, the hand-written kernel ``csrc/amm_drop.cu``
  (K8): all rounds in one cooperative launch.  Each row's eligible
  holders are listed once, and a round picks from the list; each round
  buckets its drops by worker, stably, so each worker adds its own drops
  in row order, and the kernel reproduces the plain version on the CPU
  bit for bit.

:func:`drop_rounds` picks by the device of the tensors: the plain version
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

MAX_ROUNDS = 64    # plan_drop_rounds' bound on K
MAX_BLOCKS = 1024  # csrc/amm_drop.cu: the most blocks its block prefix has room for
SHORT_LIST = 32767  # csrc/amm_drop.cu: the most workers its int16 holder lists hold


class DropBatch(NamedTuple):
    """SoA view of one AMM round over replicated tasks."""

    holders: np.ndarray   # bool[R, W] replica matrix
    excluded: np.ndarray  # bool[R, W] holders that must not drop (active use)
    nbytes: np.ndarray    # f32[R] replica size
    ndrop: np.ndarray     # i32[R] replicas to shed per task
    mem: np.ndarray       # f32[W] projected managed memory per worker


def drop_rounds_reference(holders, excluded, nbytes, ndrop, mem, rounds: int):
    """The ``rounds`` Jacobi rounds in torch ops: the plain version of K8.
    Returns ``(drops i32[R, rounds], mem f32[W])``: the worker row r drops
    from in round k, or -1.  The inputs are not changed."""
    R, W = holders.shape
    dev = mem.device
    cols = torch.arange(W, device=dev)
    neg = torch.tensor(float("-inf"), dtype=torch.float32, device=dev)
    drops = torch.full((R, rounds), -1, dtype=torch.int32, device=dev)
    for k in range(rounds):
        nrep = holders.sum(dim=1)
        can = holders & ~excluded & (ndrop > 0)[:, None] & (nrep > 1)[:, None]
        score = torch.where(can, mem[None, :], neg)
        w = torch.argmax(score, dim=1)  # the first maximum
        ok = can.gather(1, w[:, None])[:, 0]
        holders = holders & ~(ok[:, None] & (cols[None, :] == w[:, None]))
        ndrop = ndrop - ok.to(ndrop.dtype)
        shed = torch.zeros(W + 1, dtype=torch.float32, device=dev)
        shed.index_add_(0, torch.where(ok, w, W), torch.where(ok, nbytes, 0.0))
        mem = torch.clamp_min(mem - shed[:W], 0.0)
        drops[:, k] = torch.where(ok, w, -1).to(torch.int32)
    return drops, mem


def drop_rounds_cuda(holders, excluded, nbytes, ndrop, mem, rounds: int, blocks: int | None = None,
                     stamps=None):
    """The rounds through the hand-written kernel ``csrc/amm_drop.cu``: one
    cooperative launch of ``blocks`` blocks (by default as many as the
    card holds at once, up to two a multiprocessor) for all rounds.  Same
    arguments and results as :func:`drop_rounds_reference`, and the
    result does not depend on the grid; ``drop_rounds_cuda.launches``
    counts the launches (none without rows, workers or rounds).

    ``stamps``, an int64 CUDA tensor of ``2 + rounds * len(DROP_PHASES)``
    set to 0, receives the device clock (ns) at the start, at the end of
    the prologue and at the end of each phase of each round that ran (the
    run stops after a round that dropped nothing); the results do not
    change."""
    dev = mem.device
    if dev.type != "cuda":
        raise RuntimeError(f"drop_rounds_cuda needs CUDA tensors, got {dev}")
    R, W = holders.shape
    for name, t, dtype, shape in (
        ("holders", holders, torch.bool, (R, W)), ("excluded", excluded, torch.bool, (R, W)),
        ("nbytes", nbytes, torch.float32, (R,)), ("ndrop", ndrop, torch.int32, (R,)),
        ("mem", mem, torch.float32, (W,)),
    ):
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"drop_rounds_cuda: {name} must be {dtype}{list(shape)} on {dev}")
    n_stamps = 2 + max(rounds, 0) * len(DROP_PHASES)
    if stamps is not None and (stamps.dtype != torch.int64 or tuple(stamps.shape) != (n_stamps,)
                               or stamps.device != dev or not stamps.is_contiguous()):
        raise ValueError(f"drop_rounds_cuda: stamps must be a contiguous int64[{n_stamps}] on {dev}")
    if blocks is not None and not 1 <= blocks <= MAX_BLOCKS:
        raise ValueError(f"drop_rounds_cuda: blocks must lie in [1, {MAX_BLOCKS}], got {blocks}")
    drops = torch.full((R, max(rounds, 0)), -1, dtype=torch.int32, device=dev)
    mem_out = mem.contiguous().clone()
    if R == 0 or W == 0 or rounds <= 0:
        return drops, mem_out
    lib = _build.load()
    # the kernel clears replica bits and counts drops down in its own copies
    hold = holders.to(torch.uint8, copy=True).contiguous()
    left = ndrop.clone().contiguous()
    P = _build.ptr
    with torch.cuda.device(dev):
        if blocks is None:
            grid = ctypes.c_int(0)
            _build.check(lib.dtpu_amm_drop_grid(W, ctypes.byref(grid)), "dtpu_amm_drop_grid")
            blocks = grid.value
        # rows' picks, replica counts and bucketed bytes; workers' totals and
        # bucket starts; blocks' totals and their (block, worker) counts;
        # rows' list lengths; and each row's list of eligible holders
        scratch = torch.empty(4 * R + 2 * W + blocks * (W + 1), dtype=torch.int32, device=dev)
        lists = torch.empty(R * W, dtype=torch.int16 if W <= SHORT_LIST else torch.int32,
                            device=dev)
        _build.check(_build.launch(dev, lib.dtpu_amm_drop,
            P(hold), P(excluded.contiguous()), P(nbytes.contiguous()), P(left), P(mem_out),
            P(drops), P(scratch), P(lists), None if stamps is None else P(stamps), R, W,
            int(rounds), blocks,
        ), "dtpu_amm_drop")
        drop_rounds_cuda.launches += 1
    return drops, mem_out


drop_rounds_cuda.launches = 0  # kernel launches in this process

# the phases of a round in K8's timeline, in order
DROP_PHASES = ("picks", "offsets", "placement", "sums")


def drop_rounds(holders, excluded, nbytes, ndrop, mem, rounds: int):
    """The rounds on the tensors' device: the plain version for CPU
    tensors, K8 otherwise (which raises off CUDA)."""
    fn = drop_rounds_reference if mem.device.type == "cpu" else drop_rounds_cuda
    return fn(holders, excluded, nbytes, ndrop, mem, rounds)


def plan_drop_rounds(batch: DropBatch, rounds: int | None = None,
                     device=None) -> list[list[tuple[int, int]]]:
    """Select replica drops; returns rounds of [(task_row, worker_idx)].
    Drops within one round were selected against the same (round-start)
    memory projection — Jacobi, where the python policy is Gauss-Seidel.
    ``device=None`` means CUDA.

    Rows and rounds are padded to power-of-two buckets as the reference
    pads them for its jit cache (padding rows ask for no drop); the rounds
    past the caller's bound are cut from the result."""
    dev = resolve_device(device)
    R = len(batch.nbytes)
    if R == 0:
        return []
    K = rounds if rounds is not None else int(max(batch.ndrop.max(), 1))
    K = min(K, MAX_ROUNDS)
    Kp = _bucket(K, floor=1)
    Rp = _bucket(R, floor=64)
    W = batch.holders.shape[1]

    def pad(arr, shape, dtype):
        buf = np.zeros(shape, dtype)
        buf[:R] = arr
        return torch.from_numpy(buf).to(dev)

    drops, _ = drop_rounds(
        pad(batch.holders, (Rp, W), bool), pad(batch.excluded, (Rp, W), bool),
        pad(batch.nbytes, Rp, np.float32), pad(batch.ndrop, Rp, np.int32),
        torch.as_tensor(np.asarray(batch.mem, np.float32)).to(dev), Kp,
    )
    drops = drops[:R, :K].cpu().numpy()
    out: list[list[tuple[int, int]]] = []
    for k in range(drops.shape[1]):
        col = drops[:, k]
        rnd = [(int(r), int(col[r])) for r in np.nonzero(col >= 0)[0]]
        if rnd:
            out.append(rnd)
    return out


def plan_drops(batch: DropBatch, rounds: int | None = None,
               device=None) -> list[tuple[int, int]]:
    """Flat [(task_row, worker_idx)] in application (round) order."""
    return [d for rnd in plan_drop_rounds(batch, rounds, device) for d in rnd]
