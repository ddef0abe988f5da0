"""Ring attention, PyTorch + CUDA port: the forward.

The counterpart of ``distributed_tpu/ops/ring_attention.py``: exact
attention over a sequence sharded along a 1-D mesh, each shard keeping
its Q block while the K/V blocks move one shard on at every step
(``ops.ici.ring_exchange``, the comm interface's ``ppermute``).

The reference folds each arriving block into a running ``(m, l, acc)``
(``_block_attn``).  Here each visible block goes through flash attention
(kernel K2, ``ops/flash.py::flash_forward``: the hand kernel on CUDA, its
plain version on the CPU), which returns the block's normalized O and its
logsumexp, and the pairs are merged in f32 by torch ops:
``lse' = logaddexp(lse, lse_b)``, ``O' = O e^(lse - lse') + O_b e^(lse_b -
lse')``.  Shard ``i`` sees its own block first (causal on the diagonal),
so no row is ever fully masked; under ``causal`` the blocks of later
shards are skipped and the earlier ones are not masked.
:func:`ring_attention_reference` replays the reference's recurrence in
torch, the plain version the kernel path is held against.

The kernel path against the plain version, per element (:func:`ring_excess`):

    |o - o_plain| <= rtol (|o_plain| + sum_b w_b |O_b|) + u sum_b w_b T_b + atol

with ``w_b = exp(lse_b - lse)`` each block's share of the row, ``T_b`` its
``(P|V|)/l`` term and ``(rtol, atol)``, ``u`` K2's (``flash.O_TOL``,
``flash.P_ROUNDOFF``): K2's contract holds for every block's O, which the
kernel returns in the input dtype, and the merge adds them with weights
that sum to one; the last ``rtol |o_plain|`` is the final cast.  The f32
merge's own rounding is far inside ``atol``.
"""

from __future__ import annotations

import torch

from distributed_tpu_torch.ops import flash
from distributed_tpu_torch.ops.comm import LocalShards
from distributed_tpu_torch.ops.ici import local_parts

_NEG = -1e30  # finite "-inf": keeps exp() NaN-free for fully masked rows


def _heads_first(parts):
    return [x.transpose(0, 1).contiguous() for x in parts]


def _visible(d: int, owner: int, causal: bool) -> bool:
    return not causal or owner <= d


def _merge(o, lse, o_b, lse_b):
    """Fold one block's (O, lse) into the running pair, in f32."""
    o_b = o_b.float()
    if o is None:
        return o_b, lse_b
    new = torch.logaddexp(lse, lse_b)
    return o * torch.exp(lse - new) + o_b * torch.exp(lse_b - new), new


def _ring_fold(comm, n_dev, qt, kt, vt, causal, scale):
    """The ring on ``[H, n, D]`` shards: K2 a visible block, merged in f32.
    Returns each shard's O (f32) and lse."""
    S = len(qt)
    o, lse = [None] * S, [None] * S
    for step in range(n_dev):
        for j, d in enumerate(comm.local):
            owner = (d - step) % n_dev
            if not _visible(d, owner, causal):
                continue
            o_b, lse_b = flash.flash_forward(qt[j], kt[j], vt[j], causal and owner == d, scale)
            o[j], lse[j] = _merge(o[j], lse[j], o_b, lse_b)
        if step < n_dev - 1:
            kt = comm.ppermute(kt, 1)
            vt = comm.ppermute(vt, 1)
    return o, lse


def ring_attention(mesh, q, k, v, axis: str = "sp", causal: bool = False,
                   scale: float | None = None, comm=None):
    """Exact multi-head attention with the sequence sharded over
    ``mesh[axis]``.

    ``q, k, v``: ``[seq, heads, dim]`` global arrays (seq divisible by the
    axis size) or lists of this process's shards.  Returns the list of
    this process's ``[seq / n, heads, dim]`` output shards, in the input
    dtype, each on its shard's device.  ``comm`` defaults to
    :class:`LocalShards`."""
    n_dev = mesh.shape[axis]
    comm = comm or LocalShards(mesh)
    qs, ks, vs = (local_parts(mesh, comm, x) for x in (q, k, v))
    if scale is None:
        scale = 1.0 / (qs[0].shape[-1] ** 0.5)
    o, _ = _ring_fold(comm, n_dev, *(_heads_first(p) for p in (qs, ks, vs)), bool(causal),
                      float(scale))
    return [x.to(qs[0].dtype).transpose(0, 1) for x in o]


def _block_attn(q, k, v, m, l, acc, qoff, koff, scale, causal):
    """The reference's online-softmax step (``_block_attn``), f32:
    q ``[nq, H, D]``; k, v ``[nk, H, D]``; m, l ``[H, nq]``; acc ``[nq, H, D]``."""
    s = torch.einsum("qhd,khd->hqk", q, k) * scale
    if causal:
        qpos = qoff + torch.arange(q.shape[0], device=q.device)
        kpos = koff + torch.arange(k.shape[0], device=q.device)
        s = torch.where((qpos[:, None] >= kpos[None, :])[None], s, _NEG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[:, :, None])
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha.T[:, :, None] + torch.einsum("hqk,khd->qhd", p, v)
    return m_new, l_new, acc_new


def ring_attention_reference(mesh, q, k, v, axis: str = "sp", causal: bool = False,
                             scale: float | None = None, comm=None):
    """Plain version: the reference's ring, ``n`` steps of ``_block_attn``
    in f32 with a ``ppermute`` of K and V after each, the masked blocks
    folded in as the reference folds them.  Same arguments and result as
    :func:`ring_attention`."""
    n_dev = mesh.shape[axis]
    comm = comm or LocalShards(mesh)
    qs, ks, vs = (local_parts(mesh, comm, x) for x in (q, k, v))
    if scale is None:
        scale = 1.0 / (qs[0].shape[-1] ** 0.5)
    out = []
    carry = []
    for j, d in enumerate(comm.local):
        nq, H = qs[j].shape[0], qs[j].shape[1]
        dev = qs[j].device
        carry.append((torch.full((H, nq), _NEG, device=dev), torch.zeros((H, nq), device=dev),
                      torch.zeros(qs[j].shape, device=dev)))
    kf = [x.float() for x in ks]
    vf = [x.float() for x in vs]
    for step in range(n_dev):
        for j, d in enumerate(comm.local):
            nq = qs[j].shape[0]
            koff = ((d - step) % n_dev) * kf[j].shape[0]
            carry[j] = _block_attn(qs[j].float(), kf[j], vf[j], *carry[j], d * nq, koff,
                                   scale, causal)
        kf = comm.ppermute(kf, 1)
        vf = comm.ppermute(vf, 1)
    for j in range(len(qs)):
        _, l, acc = carry[j]
        out.append((acc / torch.clamp_min(l, 1e-30).T[:, :, None]).to(qs[j].dtype))
    return out


def ring_rounding_terms(q, k, v, n_dev: int, causal: bool, scale: float):
    """Per shard of the ``[seq, heads, dim]`` global arrays: ``(sum_b w_b
    |O_b|, sum_b w_b T_b)`` in f32, ``[seq / n, heads, dim]`` each, from
    the plain blocks (:func:`ring_excess` states the bound they enter)."""
    qs, ks, vs = (_heads_first(x.chunk(n_dev)) for x in (q, k, v))
    out = []
    for i in range(n_dev):
        blocks = []
        for j in range(n_dev):
            if not _visible(i, j, causal):
                continue
            cb = causal and i == j
            q32, k32, v32 = qs[i].float(), ks[j].float(), vs[j].float()
            o_b, lse_b = flash.flash_forward_reference(q32, k32, v32, cb, scale)
            t_b = flash.pv_rounding_term(qs[i], ks[j], vs[j], cb, scale, lse_b)
            blocks.append((o_b.abs(), t_b, lse_b))
        lse = torch.logsumexp(torch.stack([b[2] for b in blocks]), dim=0)
        t_o = sum(torch.exp(lse_b - lse) * o_b for o_b, _, lse_b in blocks)
        t_p = sum(torch.exp(lse_b - lse) * t_b for _, t_b, lse_b in blocks)
        out.append((t_o.transpose(0, 1), t_p.transpose(0, 1)))
    return out


def ring_excess(o, o_plain, terms) -> float:
    """Largest amount by which a shard's O exceeds the kernel path's bound
    against the plain version (the check passes at <= 0); ``terms`` is
    that shard's pair from :func:`ring_rounding_terms`."""
    rtol, atol = flash.O_TOL[o_plain.dtype]
    u = flash.P_ROUNDOFF.get(o_plain.dtype, 0.0)
    t_o, t_p = terms
    w = o_plain.float()
    d = (o.float() - w).abs() - rtol * (w.abs() + t_o) - u * t_p
    return (d.max() - atol).item()
