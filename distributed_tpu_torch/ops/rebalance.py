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
  version does (:func:`band`) and buckets the eligible keys by owner in
  the size order, with their sizes (:func:`owner_lists`), in torch ops, so
  a sender's largest remaining key is the head of its list and a round
  reads no key but the ones it moves; the kernel runs the rounds, ranks
  each round's candidates by a sort (a warp's bitonic run, merges down to
  eight runs, then one step that sums a binary search in each other run),
  writes only the moves, and stops after a round that moves nothing.
  Each worker gains or loses at most one key a round, so every memory
  update adds one value, exact in any order, and the kernel gives the
  plain version's moves and memories on the CPU bit for bit.

The plain version returns dense rows, a key and a recipient a round and
slot; the kernel returns the moves alone (:class:`Rounds`), and
:func:`compact_rounds` turns the rows into that form.
:func:`rebalance_rounds` picks by the device of the tensors: the plain
version for CPU tensors, the kernel otherwise (which raises off CUDA), in
the compact form; :func:`plan_moves` reads back only the moves.
"""

from __future__ import annotations

import ctypes
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


class Rounds(NamedTuple):
    """The rounds' moves, compact: ``moves`` i32[cap, 2], the ``(key,
    recipient)`` of each move in application order (round, then slot),
    its first ``total`` rows written; ``counts`` i32[rounds], the moves of
    each round (0 after the first that moves nothing); ``total`` i32[1];
    ``mem`` f32[W], the memories after the rounds."""

    moves: torch.Tensor
    counts: torch.Tensor
    total: torch.Tensor
    mem: torch.Tensor

    def trimmed(self) -> Rounds:
        """The same with ``moves`` cut to its ``total`` rows (reads
        ``total`` back from the card)."""
        return self._replace(moves=self.moves[:int(self.total[0])])


def compact_rounds(mk, md, mem) -> Rounds:
    """The plain version's dense rows (``-1`` for a slot that moved
    nothing) in the kernel's compact form, ``moves`` exactly ``total``
    rows."""
    live = mk >= 0
    counts = live.sum(1, dtype=torch.int32)
    return Rounds(torch.stack([mk[live], md[live]], 1), counts,
                  counts.sum(dtype=torch.int32).reshape(1), mem)


def band(mean) -> tuple[float, float]:
    """``(mean * 1.05, mean * 0.95)`` in f32 as the plain version takes
    them, on the host."""
    m = torch.tensor(mean, dtype=torch.float32)
    return float(m * 1.05), float(m * 0.95)


def owner_lists(owner, nbytes, eligible, W: int):
    """K9's per-worker lists: the eligible keys bucketed by owner, stably in
    the size order ``argsort(-nbytes, stable=True)``, in torch ops on the
    tensors' device.  Returns ``(list i32[N], size f32[N], off i32[W +
    1])``: worker w's keys, largest first, are ``list[off[w]:off[w + 1]]``
    and their sizes ``size[off[w]:off[w + 1]]``; the keys past ``off[W]``
    are the ineligible ones."""
    order = torch.argsort(-nbytes, stable=True)
    ow = torch.where(eligible[order], owner[order].to(torch.int32), W)
    ow, perm = torch.sort(ow, stable=True)
    off = torch.searchsorted(ow, torch.arange(W + 1, dtype=torch.int32, device=ow.device),
                             out_int32=True)
    lst = order[perm]
    return lst.to(torch.int32), nbytes[lst], off


def _layout(lib, W: int) -> tuple[int, bool]:
    """(bytes, in shared memory) of K9's work space for W workers on the
    current card, asked of the kernel once a (card, W)."""
    key = (torch.cuda.current_device(), W)
    if key not in _LAYOUTS:
        nbytes, shared = ctypes.c_longlong(0), ctypes.c_int(0)
        _build.check(lib.dtpu_rebalance_layout(W, ctypes.byref(nbytes), ctypes.byref(shared)),
                     "dtpu_rebalance_layout")
        _LAYOUTS[key] = int(nbytes.value), bool(shared.value)
    return _LAYOUTS[key]


_LAYOUTS: dict[tuple[int, int], tuple[int, bool]] = {}


def rebalance_rounds_cuda(owner, nbytes, eligible, mem, mean, rounds: int, stamps=None) -> Rounds:
    """The rounds through the hand-written kernel ``csrc/rebalance.cu``, one
    launch of one block a plan, on the lists of :func:`owner_lists`.  Same
    arguments as :func:`rebalance_rounds_reference`, its results in the
    compact form (:class:`Rounds`, ``compact_rounds`` of the plain
    version's); ``rebalance_rounds_cuda.launches`` counts the launches
    (none without rounds).  ``mean`` must not be negative (a projected
    memory is a sum of sizes): below 0 the band's ends cross and a worker
    could send and receive in one round, which the kernel does not take.

    ``stamps``, an int64 CUDA tensor of ``1 + rounds * len(REBALANCE_PHASES)``,
    receives the device clock (ns) at the start and at the end of each
    phase of each round that ran (``profile_periodic.phase_split`` reads
    it); the results do not change."""
    dev = mem.device
    if dev.type != "cuda":
        raise RuntimeError(f"rebalance_rounds_cuda needs CUDA tensors, got {dev}")
    N, W = owner.shape[0], mem.shape[0]
    for name, t, dtype, n in (("owner", owner, torch.int32, N), ("nbytes", nbytes, torch.float32, N),
                              ("eligible", eligible, torch.bool, N), ("mem", mem, torch.float32, W)):
        if t.dtype != dtype or t.shape != (n,) or t.device != dev:
            raise ValueError(f"rebalance_rounds_cuda: {name} must be {dtype}[{n}] on {dev}")
    n_stamps = 1 + max(rounds, 0) * len(REBALANCE_PHASES)
    if stamps is not None and (stamps.dtype != torch.int64 or stamps.shape != (n_stamps,)
                               or stamps.device != dev or not stamps.is_contiguous()):
        raise ValueError(f"rebalance_rounds_cuda: stamps must be a contiguous int64[{n_stamps}] on {dev}")
    if mean < 0:  # a host number, as the plain version takes it
        raise ValueError(f"rebalance_rounds_cuda: the mean {mean} is negative")
    rounds = max(rounds, 0)
    # a key moves once, and a round pairs at most W // 2 slots
    cap = min(N, rounds * (W // 2))
    i32 = dict(dtype=torch.int32, device=dev)
    # the kernel writes every count and the total
    out = Rounds(torch.empty((cap, 2), **i32), torch.empty(rounds, **i32), torch.empty(1, **i32),
                 mem.contiguous().clone())
    if rounds == 0 or W == 0:
        out.counts.zero_()
        out.total.zero_()
        return out
    lib = _build.load()
    hi, lo = band(mean)
    with torch.cuda.device(dev):
        lst, size, off = owner_lists(owner, nbytes, eligible, W)
        nb, in_smem = _layout(lib, W)
        work = None if in_smem else torch.empty(nb, dtype=torch.uint8, device=dev)
        P = _build.ptr
        _build.check(_build.launch(dev, lib.dtpu_rebalance,
            P(lst), P(size), P(off), hi, lo, P(out.mem), P(out.moves), P(out.counts),
            P(out.total), None if work is None else P(work), None if stamps is None else P(stamps),
            W, rounds, cap,
        ), "dtpu_rebalance")
        rebalance_rounds_cuda.launches += 1
    return out


rebalance_rounds_cuda.launches = 0  # kernel launches in this process

# the phases of a round in K9's timeline, in order
REBALANCE_PHASES = ("compaction", "sort", "merge", "moves", "barrier")


def rebalance_rounds(owner, nbytes, eligible, mem, mean, rounds: int) -> Rounds:
    """The rounds on the tensors' device, compact: the plain version's rows
    through :func:`compact_rounds` for CPU tensors, K9 otherwise (which
    raises off CUDA)."""
    if mem.device.type == "cpu":
        return compact_rounds(*rebalance_rounds_reference(owner, nbytes, eligible, mem, mean, rounds))
    return rebalance_rounds_cuda(owner, nbytes, eligible, mem, mean, rounds)


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


def plan_moves(batch: RebalanceBatch, rounds: int | None = None,
               device=None) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Select rebalance moves: ``(keys, senders, recipients)``, int arrays
    in application order.  ``device=None`` means CUDA; ``rounds`` as
    :func:`round_count` takes it.  Only the moves come back from the card."""
    dev = resolve_device(device)
    N = len(batch.nbytes)
    if N == 0 or len(batch.mem) < 2:
        empty = np.zeros(0, np.int32)
        return empty, empty, empty
    out = rebalance_rounds(*padded_inputs(batch, dev), round_count(batch, rounds))
    moves = out.trimmed().moves.cpu().numpy()
    moves = moves[moves[:, 0] < N]  # padding keys are never eligible
    keys = moves[:, 0]
    return keys, batch.owner[keys], moves[:, 1]


def plan_rebalance(batch: RebalanceBatch, rounds: int | None = None,
                   device=None) -> list[tuple[int, int, int]]:
    """Select rebalance moves; returns ``[(key_idx, sender, recipient)]`` in
    application order (:func:`plan_moves` as a list)."""
    keys, senders, recipients = plan_moves(batch, rounds, device)
    return list(zip(keys.tolist(), senders.tolist(), recipients.tolist()))
