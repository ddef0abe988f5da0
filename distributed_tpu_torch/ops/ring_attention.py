"""Ring attention, PyTorch + CUDA port: forward and backward.

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

The backward (:class:`_RingAttention`) runs the ring again in its forward
order: at each step shard ``d`` runs flash attention's backward (kernel K3
on CUDA, its plain version on the CPU) on the block it holds, if visible,
from the residuals of the whole ring: its merged lse and the O the caller
received.  So ``P_b = exp(S_b - lse)`` and ``delta = rowsum(dO * O)`` are
the global ones, and each call returns exactly block ``b``'s share of the
gradient.  dQ accumulates in f32 on its shard; each block's dK/dV
accumulate in f32 and ride the ring with the block, and one last
``ppermute`` takes them home.  Each gradient is cast once, at the end.
:func:`ring_backward_reference` (autograd through the plain ring) is the
plain version, and per shard and G in (dQ, dK, dV) (:func:`ring_bwd_excess`):

    |G - G_plain| <= sum_b (rtol |G_b| + u T_{G,b} + D_{G,b} + atol) + rtol |G_plain|

with ``G_b`` block ``b``'s share, ``T_{G,b}`` its rounding term
(``flash.bwd_rounding_terms``), ``(rtol, atol)``, ``u`` K3's
(``flash.BWD_TOL``, ``flash.P_ROUNDOFF``) and ``D_{G,b}`` what the
residuals move: K3 takes delta from the O the caller received, rounded to
the input dtype, where autograd of the plain ring differentiates its f32
O, so dS moves by ``P |delta - delta_plain|`` (``D_dQ = scale |P dd| |K|``,
``D_dK = scale |P dd|^T |Q|``, ``D_dV = 0``).
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


def _ring_backward(comm, n_dev, qt, kt, vt, ot, lse, dot, causal, scale):
    """The ring's backward on ``[H, n, D]`` shards, in the forward's step
    order: K3 a visible block from the merged residuals, dQ summed in f32
    on its shard, each block's dK/dV summed in f32 as they travel with it,
    then sent home.  Returns (dQ, dK, dV) lists in the input dtype."""
    dq, dk, dv = ([torch.zeros(x.shape, dtype=torch.float32, device=x.device) for x in xs]
                  for xs in (qt, kt, vt))
    for step in range(n_dev):
        for j, d in enumerate(comm.local):
            owner = (d - step) % n_dev
            if not _visible(d, owner, causal):
                continue
            g_q, g_k, g_v = flash.flash_backward(qt[j], kt[j], vt[j], ot[j], lse[j], dot[j],
                                                 causal and owner == d, scale)
            dq[j] += g_q.float()
            dk[j] += g_k.float()
            dv[j] += g_v.float()
        if step < n_dev - 1:
            kt, vt, dk, dv = (comm.ppermute(x, 1) for x in (kt, vt, dk, dv))
    # after n - 1 steps shard d holds block d + 1: one more step takes it home
    dk, dv = comm.ppermute(dk, 1), comm.ppermute(dv, 1)
    dtype = qt[0].dtype
    return tuple([x.to(dtype) for x in g] for g in (dq, dk, dv))


class _RingAttention(torch.autograd.Function):
    """The ring's forward (K2 a visible block, merged in f32) and its
    hand-written backward (:func:`_ring_backward`), on the ``[H, n, D]``
    shards this process holds, passed flat as ``q..., k..., v...``.  Saves
    q, k, v, each shard's O in the input dtype and its merged f32 lse.
    Once differentiable, as ``flash._FlashAttention``."""

    @staticmethod
    def forward(ctx, comm, n_dev, causal, scale, *qkv):
        S = len(qkv) // 3
        qt, kt, vt = (list(qkv[i * S:(i + 1) * S]) for i in range(3))
        o, lse = _ring_fold(comm, n_dev, qt, kt, vt, causal, scale)
        out = tuple(x.to(qt[0].dtype) for x in o)
        ctx.save_for_backward(*qt, *kt, *vt, *out, *lse)
        ctx.comm, ctx.n_dev, ctx.causal, ctx.scale, ctx.S = comm, n_dev, causal, scale, S
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *dos):
        S = ctx.S
        saved = ctx.saved_tensors
        qt, kt, vt, ot, lse = (list(saved[i * S:(i + 1) * S]) for i in range(5))
        dot = [g.to(o.dtype).contiguous() for g, o in zip(dos, ot)]
        dq, dk, dv = _ring_backward(ctx.comm, ctx.n_dev, qt, kt, vt, ot, lse, dot, ctx.causal,
                                    ctx.scale)
        return (None, None, None, None, *dq, *dk, *dv)


def ring_attention(mesh, q, k, v, axis: str = "sp", causal: bool = False,
                   scale: float | None = None, comm=None):
    """Exact multi-head attention with the sequence sharded over
    ``mesh[axis]``.

    ``q, k, v``: ``[seq, heads, dim]`` global arrays (seq divisible by the
    axis size) or lists of this process's shards.  Returns the list of
    this process's ``[seq / n, heads, dim]`` output shards, in the input
    dtype, each on its shard's device.  ``comm`` defaults to
    :class:`LocalShards`.  Differentiable: ``backward`` runs the ring's
    backward (:class:`_RingAttention`), its gradients reaching the
    caller's tensors."""
    n_dev = mesh.shape[axis]
    comm = comm or LocalShards(mesh)
    qs, ks, vs = (local_parts(mesh, comm, x) for x in (q, k, v))
    if scale is None:
        scale = 1.0 / (qs[0].shape[-1] ** 0.5)
    out = _RingAttention.apply(comm, n_dev, bool(causal), float(scale),
                               *(x for p in (qs, ks, vs) for x in _heads_first(p)))
    return [x.transpose(0, 1) for x in out]


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


def _plain_blocks(qs, ks, vs, i, n_dev, causal, scale):
    """Shard ``i``'s visible blocks in f32 (plain forward): ``[(b, o_b,
    lse_b)]`` and the merged (O, lse), ``[H, n, D]`` / ``[H, n, 1]``."""
    blocks = []
    for b in range(n_dev):
        if _visible(i, b, causal):
            o_b, lse_b = flash.flash_forward_reference(qs[i].float(), ks[b].float(),
                                                       vs[b].float(), causal and i == b, scale)
            blocks.append((b, o_b, lse_b))
    lse = torch.logsumexp(torch.stack([x[2] for x in blocks]), dim=0)
    o = sum(torch.exp(lse_b - lse) * o_b for _, o_b, lse_b in blocks)
    return blocks, o, lse


def ring_rounding_terms(q, k, v, n_dev: int, causal: bool, scale: float):
    """Per shard of the ``[seq, heads, dim]`` global arrays: ``(sum_b w_b
    |O_b|, sum_b w_b T_b)`` in f32, ``[seq / n, heads, dim]`` each, from
    the plain blocks (:func:`ring_excess` states the bound they enter)."""
    qs, ks, vs = (_heads_first(x.chunk(n_dev)) for x in (q, k, v))
    out = []
    for i in range(n_dev):
        blocks, _, lse = _plain_blocks(qs, ks, vs, i, n_dev, causal, scale)
        t_o = sum(torch.exp(lse_b - lse) * o_b.abs() for _, o_b, lse_b in blocks)
        t_p = sum(torch.exp(lse_b - lse) * flash.pv_rounding_term(
            qs[i], ks[b], vs[b], causal and i == b, scale, lse_b) for b, _, lse_b in blocks)
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


def ring_backward_reference(mesh, q, k, v, do, axis: str = "sp", causal: bool = False,
                            scale: float | None = None, comm=None, heads_at_once=None):
    """Plain version of the ring's backward: ``torch.autograd`` through
    :func:`ring_attention_reference`, independent of K2 and K3.  ``do`` is
    the output's gradient, a global array or this process's shards; the
    heads go through ``heads_at_once`` at a time (all at once for None),
    each head's attention being its own.  Returns per shard this process
    holds ``(dQ, dK, dV)``, ``[seq / n, heads, dim]`` in the input dtype."""
    comm = comm or LocalShards(mesh)
    parts = [local_parts(mesh, comm, x) for x in (q, k, v, do)]
    heads = parts[0][0].shape[1]
    step = heads_at_once or heads
    grads = [[[], [], []] for _ in parts[0]]
    for h in range(0, heads, step):
        sl = slice(h, h + step)
        qs, ks, vs = ([x[:, sl].detach().requires_grad_() for x in p] for p in parts[:3])
        out = ring_attention_reference(mesh, qs, ks, vs, axis=axis, causal=causal,
                                       scale=scale, comm=comm)
        torch.autograd.backward(out, [g[:, sl] for g in parts[3]])
        for j in range(len(qs)):
            for i, x in enumerate((qs[j], ks[j], vs[j])):
                grads[j][i].append(x.grad)
    return [tuple(torch.cat(g, dim=1) for g in gj) for gj in grads]


def ring_bwd_rounding_terms(q, k, v, o, do, n_dev: int, causal: bool, scale: float,
                            block_q: int = 128):
    """Per shard of the ``[seq, heads, dim]`` global arrays (``o`` the
    ring's output as the caller received it, ``do`` its gradient), for G in
    (dQ, dK, dV): ``(sum_b |G_b|, sum_b T_{G,b}, sum_b D_{G,b}, blocks)``,
    f32 ``[seq / n, heads, dim]`` and the count of visible blocks, from
    the plain forward's merged lse (:func:`ring_bwd_excess` states the
    bound they enter).  ``G_b`` and ``T_{G,b}`` are
    ``flash.flash_backward_reference`` / ``flash.bwd_rounding_terms`` of
    block ``b`` on the residuals K3 gets."""
    qs, ks, vs, os_, dos = (_heads_first(x.chunk(n_dev)) for x in (q, k, v, o, do))
    f32 = torch.float32
    acc = [[[torch.zeros(x.shape, dtype=f32, device=x.device) for _ in range(3)]
            for x in (qs[i], ks[i], vs[i])] for i in range(n_dev)]  # [shard][G][|G_b|, T, D]
    count = [[0, 0, 0] for _ in range(n_dev)]
    for i in range(n_dev):
        blocks, o_plain, lse = _plain_blocks(qs, ks, vs, i, n_dev, causal, scale)
        o_i, do_i = os_[i].float(), dos[i].float()
        ddelta = ((do_i * (o_i - o_plain)).sum(-1, keepdim=True)).abs()
        for b, _, _ in blocks:
            count[i][0] += 1
            count[b][1] += 1
            count[b][2] += 1
            kb = ks[b].float()
            ka = kb.abs()
            gk, gv = torch.zeros_like(kb), torch.zeros_like(kb)
            for i0, qc, dc, p, ds in flash._bwd_chunks(qs[i].float(), kb, vs[b].float(), o_i,
                                                       lse, do_i, causal and i == b, scale,
                                                       block_q):
                rows = slice(i0, i0 + qc.shape[1])
                pd = p * ddelta[:, rows]
                dsa, qa = ds.abs(), qc.abs()
                acc[i][0][0][:, rows] += (torch.matmul(ds, kb) * scale).abs()
                acc[i][0][1][:, rows] += torch.matmul(dsa, ka) * scale
                acc[i][0][2][:, rows] += torch.matmul(pd, ka) * scale
                gk += torch.matmul(ds.transpose(-1, -2), qc) * scale
                gv += torch.matmul(p.transpose(-1, -2), dc)
                acc[b][1][1] += torch.matmul(dsa.transpose(-1, -2), qa) * scale
                acc[b][1][2] += torch.matmul(pd.transpose(-1, -2), qa) * scale
                acc[b][2][1] += torch.matmul(p.transpose(-1, -2), dc.abs())
            acc[b][1][0] += gk.abs()
            acc[b][2][0] += gv.abs()
    return [[tuple(t.transpose(0, 1) for t in acc[i][g]) + (count[i][g],) for g in range(3)]
            for i in range(n_dev)]


def ring_bwd_excess(grads, grads_plain, terms) -> tuple[float, float, float]:
    """Largest amount by which each of one shard's (dQ, dK, dV) exceeds
    the kernel path's bound against the plain version (a check passes at
    <= 0); ``terms`` is that shard's entry of :func:`ring_bwd_rounding_terms`."""
    dtype = grads_plain[0].dtype
    rtol, atol = flash.BWD_TOL[dtype]
    u = flash.P_ROUNDOFF.get(dtype, 0.0)
    out = []
    for g, want, (t_g, t_r, t_d, blocks) in zip(grads, grads_plain, terms):
        w = want.float()
        d = (g.float() - w).abs() - rtol * (w.abs() + t_g) - u * t_r - t_d
        out.append((d.max() - blocks * atol).item())
    return tuple(out)


def ring_bwd_planted_faults(q, k, v, o, do, grads, n_dev: int, causal: bool, scale: float,
                            step: int = 1):
    """The gradients of two planted faults that :func:`ring_bwd_excess`
    must reject, from the ring's gradients ``grads`` (per shard (dQ, dK,
    dV)) on the ``[seq, heads, dim]`` global arrays: (a) ring step
    ``step`` left out (each shard's block at that step taken out of its dQ
    and the block owner's dK/dV, by the plain backward on the same
    residuals); (b) the middle shard's dK/dV left where the ring ends,
    never sent home, so that shard holds the next shard's.  Returns
    ``(fault_a, fault_b)``, each a list per shard of (dQ, dK, dV)."""
    qs, ks, vs, os_, dos = (_heads_first(x.chunk(n_dev)) for x in (q, k, v, o, do))
    fault_a = [[g.float().transpose(0, 1).clone() for g in gs] for gs in grads]
    for d in range(n_dev):
        owner = (d - step) % n_dev
        if not _visible(d, owner, causal):
            continue
        _, _, lse = _plain_blocks(qs, ks, vs, d, n_dev, causal, scale)
        g = flash.flash_backward_reference(qs[d].float(), ks[owner].float(), vs[owner].float(),
                                           os_[d].float(), lse, dos[d].float(),
                                           causal and owner == d, scale)
        fault_a[d][0] -= g[0]
        fault_a[owner][1] -= g[1]
        fault_a[owner][2] -= g[2]
    dtype = grads[0][0].dtype
    fault_a = [tuple(x.transpose(0, 1).to(dtype) for x in gs) for gs in fault_a]
    mid = n_dev // 2
    fault_b = list(grads)
    fault_b[mid] = (grads[mid][0], *grads[(mid + 1) % n_dev][1:])
    return fault_a, fault_b
