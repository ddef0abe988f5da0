"""Batched rebalance move selection, PyTorch port (torch ops on the
device, no hand kernel).

The counterpart of ``distributed_tpu/ops/rebalance.py``.  Keys are sorted
by size once; K Jacobi rounds then pair every over-mean sender (fullest
first, each with its largest remaining key) with an under-mean recipient
(emptiest first), inside the 1.05x band, and apply the moves to the
projected memories.

Why torch ops and not a kernel: within a round the senders and the
recipients are entries of two permutations of the workers, so every
worker gains or loses at most one key a round.  The per-worker sums then
add one value to 0, exact in any order, and the sorts are stable, so the
rounds give the same moves on the card as on the CPU with no atomics to
order.

:func:`rebalance_rounds` is the reference's ``_rebalance_rounds``
(``rebalance.py:43-105``) expression for expression: stable argsorts,
``segment_min`` as ``scatter_reduce(amin)`` with the sentinel N for a
worker without a candidate key, and ``mean`` taken once from the input,
as XLA computes ``mem.sum() / W`` on the CPU (:func:`mean_of`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from distributed_tpu_torch._device import resolve_device
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


def rebalance_rounds(owner, nbytes, eligible, mem, mean, rounds: int):
    """The ``rounds`` Jacobi rounds on the tensors' device.  Returns
    ``(mk i32[rounds, W], md i32[rounds, W], mem f32[W])``: per round and
    pairing slot the key moved and its recipient, or -1."""
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
    if dev.type == "cuda":
        rebalance_rounds.launches += 1
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


rebalance_rounds.launches = 0  # calls on a CUDA device in this process: the route's launch count


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
