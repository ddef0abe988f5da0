"""Batched rebalance move selection, PyTorch + CUDA port.

The counterpart of ``distributed_tpu/ops/rebalance.py``.  Keys are sorted
by size once; K Jacobi rounds then pair every over-mean sender (fullest
first, each with its largest remaining key) with an under-mean recipient
(emptiest first), inside the 1.05x band, and apply the moves to the
projected memories.

The rounds have two implementations with one contract, the reference's
jitted ``_rebalance_rounds`` (``rebalance.py:43-105``) as XLA computes it
on the CPU:

- :func:`rebalance_rounds_reference`, the rounds in torch ops, expression
  for expression: stable argsorts, ``segment_min`` as
  ``scatter_reduce(amin)`` with the sentinel N for a worker without a
  candidate key, and ``mean`` taken once from the input, as XLA computes
  ``mem.sum() / W`` on the CPU (:func:`mean_of`);
- :func:`rebalance_rounds_cuda`, the hand-written kernel
  ``csrc/rebalance.cu`` (K9): all rounds in one launch of one block.  The
  wrapper takes the band (``mean * 1.05``, ``mean * 0.95``) as the plain
  version does and buckets the eligible keys by owner in the size order
  (:func:`owner_lists`), in torch ops, so a sender's largest remaining key
  is the head of its list and a round reads no key but the ones it moves;
  the kernel runs the rounds, ranks each round's candidates by counting,
  and stops after a round that moves nothing.  Each worker gains or
  loses at most one key a round, so every memory update adds one value,
  exact in any order, and the kernel gives the plain version's moves and
  memories on the CPU bit for bit.

:func:`rebalance_rounds` picks by the device of the tensors: the plain
version for CPU tensors, the kernel otherwise (which raises off CUDA).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from distributed_tpu_torch._device import resolve_device
from distributed_tpu_torch.ops import _build
from distributed_tpu_torch.ops.leveled import _bucket
from distributed_tpu_torch.ops.partition import xla_sum


class RebalanceBatch(NamedTuple):
    """SoA view of one rebalance cycle over single-replica keys."""

    owner: np.ndarray      # i32[N] worker index holding the sole replica
    nbytes: np.ndarray     # f32[N] key size
    eligible: np.ndarray   # bool[N] movable (memory state, not actor, keyset)
    mem: np.ndarray        # f32[W] projected managed memory per worker


def mean_of(mem: np.ndarray) -> np.float32:
    """``mem.sum() / W`` as the reference's rounds compute it on the CPU:
    XLA's sum order, and the division by the constant W as a product with
    its f32 reciprocal."""
    mem = np.asarray(mem, np.float32)
    return np.float32(xla_sum(mem) * (np.float32(1.0) / np.float32(len(mem))))


def rebalance_rounds_reference(owner, nbytes, eligible, mem, mean, rounds: int):
    """The ``rounds`` Jacobi rounds in torch ops: the plain version of K9.
    Returns ``(mk i32[rounds, W], md i32[rounds, W], mem f32[W])``: per
    round and pairing slot the key moved and its recipient, or -1."""
    N, W = owner.shape[0], mem.shape[0]
    dev = mem.device
    f32 = dict(dtype=torch.float32, device=dev)
    mean = torch.tensor(mean, **f32)
    hi, lo = mean * 1.05, mean * 0.95
    inf = torch.tensor(float("inf"), **f32)
    owner = owner.long()
    # one global size ordering (largest first), fixed across rounds
    order = torch.argsort(-nbytes, stable=True)
    pos_of_key = torch.argsort(order, stable=True)
    slot = torch.arange(W, device=dev)
    # one more flag, never set, where the rounds' dead slots write: the
    # update is then a scatter of fixed size, with no wait on the host
    eligible = torch.cat([eligible, eligible.new_zeros(1)])
    mk = torch.full((rounds, W), -1, dtype=torch.int32, device=dev)
    md = torch.full((rounds, W), -1, dtype=torch.int32, device=dev)
    for k in range(rounds):
        sender_mask = mem > hi
        recip_mask = mem < lo
        cand = eligible[:N] & sender_mask[owner]
        pos = torch.where(cand, pos_of_key, N)
        # the first (largest) remaining candidate key of each sender
        first = torch.full((W,), N, dtype=torch.long, device=dev).scatter_reduce_(
            0, owner, pos, "amin")
        has_key = first < N
        key_of = order[first.clamp_max(N - 1)]
        s_ok = sender_mask & has_key
        sender = torch.argsort(torch.where(s_ok, -mem, inf), stable=True)
        recipient = torch.argsort(torch.where(recip_mask, mem, inf), stable=True)
        n_pairs = torch.minimum(s_ok.sum(), recip_mask.sum())
        key = key_of[sender]
        size = nbytes[key]
        live = ((slot < n_pairs) & s_ok[sender] & recip_mask[recipient]
                # never push a recipient past the 1.05 band
                & (mem[recipient] + size <= hi))
        eligible = eligible.scatter(0, torch.where(live, key, N), False)
        moved = torch.where(live, size, 0.0)
        delta = torch.zeros(W + 1, **f32).index_add_(0, torch.where(live, sender, W), moved)
        gain = torch.zeros(W + 1, **f32).index_add_(0, torch.where(live, recipient, W), moved)
        mem = mem - delta[:W] + gain[:W]
        mk[k] = torch.where(live, key, -1).to(torch.int32)
        md[k] = torch.where(live, recipient, -1).to(torch.int32)
    return mk, md, mem


WORK_BYTES = 36  # csrc/rebalance.cu's kWorkBytes: the rounds' arrays, bytes a worker


def owner_lists(owner, nbytes, eligible, W: int):
    """K9's per-worker lists: the eligible keys bucketed by owner, stably in
    the size order ``argsort(-nbytes, stable=True)``, in torch ops on the
    tensors' device.  Returns ``(list i32[N], off i32[W + 1])``: worker
    w's keys, largest first, are ``list[off[w]:off[w + 1]]``; the keys past
    ``off[W]`` are the ineligible ones."""
    order = torch.argsort(-nbytes, stable=True)
    ow = torch.where(eligible[order], owner[order].to(torch.int32), W)
    ow, perm = torch.sort(ow, stable=True)
    off = torch.searchsorted(ow, torch.arange(W + 1, dtype=torch.int32, device=ow.device),
                             out_int32=True)
    return order[perm].to(torch.int32), off


def rebalance_rounds_cuda(owner, nbytes, eligible, mem, mean, rounds: int):
    """The rounds through the hand-written kernel ``csrc/rebalance.cu``, one
    launch of one block a plan, on the lists of :func:`owner_lists`.  Same
    arguments and results as :func:`rebalance_rounds_reference`;
    ``rebalance_rounds_cuda.launches`` counts the launches (none without
    rounds).  ``mean`` must not be negative (a projected memory is a sum
    of sizes): below 0 the band's ends cross and a worker could send and
    receive in one round, which the kernel does not take."""
    dev = mem.device
    if dev.type != "cuda":
        raise RuntimeError(f"rebalance_rounds_cuda needs CUDA tensors, got {dev}")
    N, W = owner.shape[0], mem.shape[0]
    for name, t, dtype, n in (("owner", owner, torch.int32, N), ("nbytes", nbytes, torch.float32, N),
                              ("eligible", eligible, torch.bool, N), ("mem", mem, torch.float32, W)):
        if t.dtype != dtype or t.shape != (n,) or t.device != dev:
            raise ValueError(f"rebalance_rounds_cuda: {name} must be {dtype}[{n}] on {dev}")
    if mean < 0:  # a host number, as the plain version takes it
        raise ValueError(f"rebalance_rounds_cuda: the mean {mean} is negative")
    mk = torch.empty((max(rounds, 0), W), dtype=torch.int32, device=dev)
    md = torch.empty_like(mk)
    mem_out = mem.contiguous().clone()
    if rounds <= 0 or W == 0:
        return mk, md, mem_out
    lib = _build.load()
    with torch.cuda.device(dev):
        # the band as the plain version takes it; the lists
        mean_t = torch.tensor(mean, dtype=torch.float32, device=dev)
        hi, lo = mean_t * 1.05, mean_t * 0.95
        nbytes = nbytes.contiguous()
        lst, off = owner_lists(owner, nbytes, eligible, W)
        work = torch.empty(WORK_BYTES * W, dtype=torch.uint8, device=dev)
        P = _build.ptr
        _build.check(_build.launch(dev, lib.dtpu_rebalance,
            P(lst), P(nbytes), P(off), P(hi), P(lo), P(mem_out), P(mk), P(md), P(work),
            W, int(rounds),
        ), "dtpu_rebalance")
        rebalance_rounds_cuda.launches += 1
    return mk, md, mem_out


rebalance_rounds_cuda.launches = 0  # kernel launches in this process


def rebalance_rounds(owner, nbytes, eligible, mem, mean, rounds: int):
    """The rounds on the tensors' device: the plain version for CPU
    tensors, K9 otherwise (which raises off CUDA)."""
    fn = rebalance_rounds_reference if mem.device.type == "cpu" else rebalance_rounds_cuda
    return fn(owner, nbytes, eligible, mem, mean, rounds)


def round_count(batch: RebalanceBatch, rounds: int | None = None) -> int:
    """The rounds a plan runs: ``rounds``, or by default the worst sender's
    excess divided by the mean movable key size (the reference's rule, on
    the host; each round moves at most one key a sender), as a power of
    two in 8-512."""
    if rounds is None:
        mean = float(batch.mem.sum()) / len(batch.mem)
        excess = float((batch.mem - mean).max())
        movable = batch.nbytes[batch.eligible]
        avg = float(movable.mean()) if len(movable) else 1.0
        rounds = int(excess / max(avg, 1.0)) + 2
    return int(np.clip(_bucket(rounds, floor=8), 8, 512))


def padded_inputs(batch: RebalanceBatch, device) -> tuple:
    """:func:`rebalance_rounds`' inputs on ``device`` but the rounds: the
    keys padded to a power-of-two bucket as the reference pads them
    (padding keys are never eligible), the memory, and its mean."""
    N = len(batch.nbytes)
    Np = _bucket(N, floor=64)

    def pad(arr, dtype):
        buf = np.zeros(Np, dtype)
        buf[:N] = arr
        return torch.from_numpy(buf).to(device)

    mem = np.asarray(batch.mem, np.float32)
    return (pad(batch.owner, np.int32), pad(batch.nbytes, np.float32), pad(batch.eligible, bool),
            torch.from_numpy(mem.copy()).to(device), mean_of(mem))


def plan_rebalance(batch: RebalanceBatch, rounds: int | None = None,
                   device=None) -> list[tuple[int, int, int]]:
    """Select rebalance moves; returns ``[(key_idx, sender, recipient)]`` in
    application order.  ``device=None`` means CUDA; ``rounds`` as
    :func:`round_count` takes it."""
    dev = resolve_device(device)
    N = len(batch.nbytes)
    if N == 0 or len(batch.mem) < 2:
        return []
    mk, md, _ = rebalance_rounds(*padded_inputs(batch, dev), round_count(batch, rounds))
    mk, md = mk.cpu().numpy(), md.cpu().numpy()
    owner = batch.owner
    out: list[tuple[int, int, int]] = []
    for k in range(mk.shape[0]):
        for s in np.nonzero(mk[k] >= 0)[0]:
            key = int(mk[k, s])
            if key < N:
                out.append((key, int(owner[key]), int(md[k, s])))
    return out
