"""Flash attention, PyTorch + CUDA port.

The counterpart of ``distributed_tpu/ops/flash.py``: tiled
online-softmax attention that never holds the ``[N, Nk]`` score matrix,
differentiable as the reference's ``custom_vjp`` is.  On CUDA tensors
the forward runs the hand-written kernel ``csrc/flash_fwd.cu`` (K2) and
the backward ``csrc/flash_bwd.cu`` (K3); on CPU tensors both run their
plain versions, :func:`flash_forward_reference` and
:func:`flash_backward_reference`, the same math in plain torch ops.
:class:`_FlashAttention` ties the two together for autograd.  Layout,
defaults, block clamping, the ``-1e30`` mask, the ``[H, N, 1]`` f32
logsumexp and the backward's order of operations follow the reference.

Each kernel has two bodies: bf16 / f16 inputs run on the tensor cores,
which round P (and in the backward dS) once to the input type before a
product with it; f32 inputs run on the CUDA cores in f32.
:func:`pv_rounding_term` and :func:`bwd_rounding_terms` give the error
bounds that this rounding implies.
"""

from __future__ import annotations

import torch

from distributed_tpu_torch._device import resolve_device
from distributed_tpu_torch.ops import _build

_NEG = -1e30  # finite "-inf": fully masked rows stay NaN-free

# kernel dtype codes (csrc/flash_fwd.cu)
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
HEAD_DIMS_CUDA = (64, 128)
# unit roundoff of the P the tensor-core body rounds to the input type
P_ROUNDOFF = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}
# the kernel's O against the plain version's, per element:
#   |o - o_plain| <= rtol * |o_plain| + u * (P.|V|) / l + atol.
# In bf16 / f16 both sides round one f32 value to the input type, at most
# one unit in the last place: 2**-7 (bf16) or 2**-10 (f16) of the value.
# The tensor-core body also rounds each p in [0, 1] once to the input
# type before P.V, moving it by at most u*p and O by at most
# u * (P.|V|) / l (pv_rounding_term).  atol covers the order of the f32
# sums near zero; in f32 (CUDA-core body) only that order differs.
O_TOL = {torch.bfloat16: (2.0 ** -7, 1e-5), torch.float16: (2.0 ** -10, 1e-5),
         torch.float32: (0.0, 1e-4)}


# the backward's gradients against the plain version's on identical
# residuals (q, k, v, o, lse, dO), per element, for G in dQ, dK, dV:
#   |G - G_plain| <= rtol * |G_plain| + u * T_G + atol,
#   T_dV = P^T.|dO|,  T_dK = scale * |dS|^T.|Q|,  T_dQ = scale * |dS|.|K|
# (bwd_rounding_terms).  rtol is the final cast's unit in the last place
# (as O_TOL); u the one rounding of P before P^T.dO and of dS before
# dS^T.Q and dS.K in the tensor-core body (P_ROUNDOFF), 0 in f32.  atol
# covers the f32 sums taken in another order: over the head dim for S
# and dP, whose error a p then carries into P and dS, and over the
# sequence for the products.  On an H100 the f32 body moved a gradient
# by at most 4.8e-6 at seq 1024 (chip_smoke.py phase 2b prints it), and
# a 64-row tile left out exceeds the bound by 0.037 or more at seq 8192.
BWD_TOL = {torch.bfloat16: (2.0 ** -7, 1e-4), torch.float16: (2.0 ** -10, 1e-4),
           torch.float32: (0.0, 1e-4)}
# end to end (K2 then K3 against the plain forward then backward) the
# residuals differ too: K2's O by its rounding of P, its lse by up to
# 1e-3, and delta and P move with them.  So that check is normwise:
#   max |G - G_plain| <= E2E_RTOL * max |G_plain|.
# Both bodies' roundings emulated in f32 at seq 1024 give 0.003-0.006
# (bf16) and 0.0003-0.0009 (f16); f32 only reorders sums.
E2E_RTOL = {torch.bfloat16: 2.0 ** -5, torch.float16: 2.0 ** -8, torch.float32: 1e-4}
# rows a block of K3's tensor-core body owns (csrc/flash_bwd.cu kResRows):
# its lse / delta scratch is padded to a multiple of this per head
BWD_PAD_ROWS = 128


def _acc_dtype(dtype):
    """The dtype the plain versions compute in: f32, or f64 for f64."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def flash_forward_reference(qt, kt, vt, causal: bool, scale: float):
    """Plain version: ``[H, N, D]`` inputs -> (O in q's dtype, lse f32
    ``[H, N, 1]``), in f32 (f64 for f64 inputs), with one tile spanning
    the whole sequence."""
    acc = _acc_dtype(qt.dtype)
    q = qt.to(acc) * scale
    s = torch.matmul(q, kt.to(acc).transpose(-1, -2))  # [H, N, Nk]
    if causal:
        n, nk = qt.shape[1], kt.shape[1]
        qpos = torch.arange(n, device=qt.device)[:, None]
        kpos = torch.arange(nk, device=qt.device)[None, :]
        s = torch.where(qpos >= kpos, s, _NEG)
    m = torch.clamp_min(s.amax(dim=-1, keepdim=True), _NEG)
    p = torch.exp(s - m)
    l = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    o = torch.matmul(p, vt.to(acc)) / l
    return o.to(qt.dtype), m + torch.log(l)


def pv_rounding_term(qt, kt, vt, causal: bool, scale: float, lse):
    """``(P·|V|) / l`` per element of O, in f32, from the plain version's
    ``lse`` (``P / l = exp(s - lse)``): rounding each entry of P by at
    most a unit roundoff ``u`` moves O by at most ``u`` times this."""
    s = torch.matmul(qt.to(torch.float32) * scale, kt.to(torch.float32).transpose(-1, -2))
    if causal:
        n, nk = qt.shape[1], kt.shape[1]
        qpos = torch.arange(n, device=qt.device)[:, None]
        kpos = torch.arange(nk, device=qt.device)[None, :]
        s = torch.where(qpos >= kpos, s, _NEG)
    return torch.matmul(torch.exp(s - lse), vt.to(torch.float32).abs())


def o_excess(o, o_plain, pv_term=0.0) -> float:
    """Largest amount by which O exceeds :data:`O_TOL` against the plain
    version (the check passes at <= 0); ``pv_term`` is
    ``u * pv_rounding_term(...)`` where the kernel rounds P, else 0."""
    rtol, atol = O_TOL[o_plain.dtype]
    d = (o.float() - o_plain.float()).abs() - rtol * o_plain.float().abs() - pv_term
    return (d.max() - atol).item()


def flash_forward_cuda(qt, kt, vt, causal: bool, scale: float):
    """The hand-written kernel: ``[H, N, D]`` CUDA inputs of one float
    dtype -> (O, lse f32 ``[H, N, 1]``)."""
    if qt.device.type != "cuda":
        raise RuntimeError(f"flash_forward_cuda needs CUDA tensors, got {qt.device}")
    if not (qt.dtype == kt.dtype == vt.dtype) or qt.dtype not in _DTYPES:
        raise ValueError(f"q, k, v must share one of {list(_DTYPES)}")
    if qt.dim() != 3 or kt.shape != vt.shape or kt.dim() != 3:
        raise ValueError("q must be [H, N, D] and k, v [H, Nk, D]")
    h, n, d = qt.shape
    if kt.shape[0] != h or kt.shape[2] != d:
        raise ValueError("q, k, v must share heads and head dim")
    if d not in HEAD_DIMS_CUDA:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS_CUDA}")
    if not (qt.is_contiguous() and kt.is_contiguous() and vt.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if not (qt.device == kt.device == vt.device):
        raise ValueError("q, k, v must be on one device")
    if any(x.data_ptr() % 16 for x in (qt, kt, vt)):
        raise ValueError("q, k, v must start on 16-byte boundaries")
    o = torch.empty_like(qt)
    lse = torch.empty((h, n, 1), dtype=torch.float32, device=qt.device)
    lib = _build.load()
    P = _build.ptr
    rc = _build.launch(qt.device, lib.dtpu_flash_fwd,
        P(qt), P(kt), P(vt), P(o), P(lse),
        h, n, kt.shape[1], d, _DTYPES[qt.dtype], int(bool(causal)), float(scale),
    )
    _build.check(rc, "dtpu_flash_fwd")
    flash_forward_cuda.launches += 1
    return o, lse


flash_forward_cuda.launches = 0  # kernel launches in this process


def flash_forward(qt, kt, vt, causal: bool, scale: float):
    """``[H, N, D]`` forward -> (O, lse ``[H, N, 1]``): the plain version
    for CPU tensors, the hand kernel otherwise (which raises off CUDA)."""
    if qt.device.type == "cpu":
        return flash_forward_reference(qt, kt, vt, causal, scale)
    return flash_forward_cuda(qt, kt, vt, causal, scale)


def _bwd_chunks(qt, kt, vt, o, lse, do, causal, scale, block_q):
    """The reference's backward loop (``_flash_diff_bwd``) over q-chunks
    of ``block_q`` rows, in f32 (f64 for f64 inputs): yields ``(i0, qc,
    dc, p, ds)`` per chunk, with ``s = (q.k^T) * scale`` masked by
    ``-1e30``, ``p = exp(s - lse)`` and ``ds = p * (dO.V^T - delta)``,
    ``delta = rowsum(dO * O)`` from O as stored in the input dtype.
    Temporaries are ``[H, block_q, Nk]``, never ``[H, N, Nk]``."""
    acc = _acc_dtype(qt.dtype)
    h, n, _ = qt.shape
    nk = kt.shape[1]
    kf, vf, dof = kt.to(acc), vt.to(acc), do.to(acc)
    lse = lse.reshape(h, n, 1).to(acc)
    delta = (dof * o.to(acc)).sum(-1, keepdim=True)  # [H, N, 1]
    kpos = torch.arange(nk, device=qt.device)[None, :]
    for i0 in range(0, n, block_q):
        i1 = min(i0 + block_q, n)
        qc, dc = qt[:, i0:i1].to(acc), dof[:, i0:i1]
        s = torch.matmul(qc, kf.transpose(-1, -2)) * scale  # [H, TQ, Nk]
        if causal:
            qpos = torch.arange(i0, i1, device=qt.device)[:, None]
            s = torch.where(qpos >= kpos, s, _NEG)
        p = torch.exp(s - lse[:, i0:i1])
        ds = p * (torch.matmul(dc, vf.transpose(-1, -2)) - delta[:, i0:i1])
        yield i0, qc, dc, p, ds


def flash_backward_reference(qt, kt, vt, o, lse, do, causal: bool, scale: float,
                             block_q: int = 128):
    """Plain version of the backward: the residuals ``q, k, v, o`` and
    ``lse`` (``[H, N, 1]`` or ``[H, N]``) and ``dO`` ``[H, N, D]`` ->
    (dQ, dK, dV) in the input dtype, computed as the reference's
    ``_flash_diff_bwd`` does: ``dV += p^T.dO``, ``dQ = ds.K * scale`` and
    ``dK += (ds^T.q) * scale`` chunk by chunk, in chunk order."""
    acc = _acc_dtype(qt.dtype)
    dq = torch.empty(qt.shape, dtype=acc, device=qt.device)
    dk = torch.zeros(kt.shape, dtype=acc, device=qt.device)
    dv = torch.zeros(vt.shape, dtype=acc, device=qt.device)
    kf = kt.to(acc)
    for i0, qc, dc, p, ds in _bwd_chunks(qt, kt, vt, o, lse, do, causal, scale, block_q):
        dv += torch.matmul(p.transpose(-1, -2), dc)
        dq[:, i0:i0 + qc.shape[1]] = torch.matmul(ds, kf) * scale
        dk += torch.matmul(ds.transpose(-1, -2), qc) * scale
    return dq.to(qt.dtype), dk.to(kt.dtype), dv.to(vt.dtype)


def bwd_rounding_terms(qt, kt, vt, o, lse, do, causal: bool, scale: float,
                       block_q: int = 128):
    """``(T_dQ, T_dK, T_dV) = (scale * |dS|.|K|, scale * |dS|^T.|Q|,
    P^T.|dO|)`` from the plain version's P and dS, in f32: rounding each
    entry of dS and P by at most a unit roundoff ``u`` moves dQ, dK and
    dV by at most ``u`` times these."""
    acc = _acc_dtype(qt.dtype)
    tq = torch.empty(qt.shape, dtype=acc, device=qt.device)
    tk = torch.zeros(kt.shape, dtype=acc, device=qt.device)
    tv = torch.zeros(vt.shape, dtype=acc, device=qt.device)
    ka = kt.to(acc).abs()
    for i0, qc, dc, p, ds in _bwd_chunks(qt, kt, vt, o, lse, do, causal, scale, block_q):
        ds = ds.abs()
        tv += torch.matmul(p.transpose(-1, -2), dc.abs())
        tq[:, i0:i0 + qc.shape[1]] = torch.matmul(ds, ka) * scale
        tk += torch.matmul(ds.transpose(-1, -2), qc.abs()) * scale
    return tq, tk, tv


def bwd_excess(grads, grads_plain, terms=None) -> tuple[float, float, float]:
    """Largest amount by which each of (dQ, dK, dV) exceeds
    :data:`BWD_TOL` against the plain version (a check passes at <= 0);
    ``terms`` is :func:`bwd_rounding_terms`'s, used where the kernel
    rounds P and dS (bf16 / f16), else ignored."""
    dtype = grads_plain[0].dtype
    rtol, atol = BWD_TOL[dtype]
    u = P_ROUNDOFF.get(dtype, 0.0)
    out = []
    for i, (g, want) in enumerate(zip(grads, grads_plain)):
        w = want.float()
        d = (g.float() - w).abs() - rtol * w.abs()
        if u and terms is not None:
            d -= u * terms[i].float()
        out.append((d.max() - atol).item())
    return tuple(out)


def bwd_planted_faults(qt, kt, vt, o, lse, do, causal: bool, scale: float, grads_plain):
    """The gradients of two planted faults that a check against
    :data:`BWD_TOL` must reject: (a) the middle q-tile of 64 rows left
    out of dK and dV, (b) the middle k-tile of 64 keys that some query
    sees (under causal, keys below ``min(N, Nk)``) left out of dQ, as by
    a kernel that skips one of its 64-row tiles' products.  Returns
    ``((dQ, dK_a, dV_a), (dQ_b, dK, dV))`` from the plain gradients."""
    rows = 64
    dq, dk, dv = (g.float() for g in grads_plain)
    n, nk = qt.shape[1], kt.shape[1]
    lo = n // 2 // rows * rows
    klo = (min(n, nk) if causal else nk) // 2 // rows * rows
    ks = kt[:, klo:klo + rows].float()
    dk_a, dv_a, dq_b = dk.clone(), dv.clone(), dq.clone()
    for i0, qc, dc, p, ds in _bwd_chunks(qt, kt, vt, o, lse, do, causal, scale, rows):
        if i0 == lo:
            dv_a -= torch.matmul(p.transpose(-1, -2), dc)
            dk_a -= torch.matmul(ds.transpose(-1, -2), qc) * scale
        dq_b[:, i0:i0 + qc.shape[1]] -= torch.matmul(ds[:, :, klo:klo + rows], ks) * scale
    dt = qt.dtype
    return ((grads_plain[0], dk_a.to(dt), dv_a.to(dt)),
            (dq_b.to(dt), grads_plain[1], grads_plain[2]))


def flash_backward_cuda(qt, kt, vt, o, lse, do, causal: bool, scale: float):
    """The hand-written backward: residuals and ``dO`` on one CUDA device,
    ``[H, N, D]`` (q, o, dO) and ``[H, Nk, D]`` (k, v) of one float dtype,
    lse f32 ``[H, N, 1]`` -> (dQ, dK, dV) in that dtype.  Three launches:
    delta (and a padded copy of lse), then dK/dV by k-tile, then dQ by
    q-tile; no atomics, so two calls on the same inputs give the same
    bits."""
    if qt.device.type != "cuda":
        raise RuntimeError(f"flash_backward_cuda needs CUDA tensors, got {qt.device}")
    if not (qt.dtype == kt.dtype == vt.dtype == o.dtype == do.dtype) or qt.dtype not in _DTYPES:
        raise ValueError(f"q, k, v, o, dO must share one of {list(_DTYPES)}")
    if qt.dim() != 3 or kt.dim() != 3 or kt.shape != vt.shape:
        raise ValueError("q must be [H, N, D] and k, v [H, Nk, D]")
    h, n, d = qt.shape
    if kt.shape[0] != h or kt.shape[2] != d:
        raise ValueError("q, k, v must share heads and head dim")
    if o.shape != qt.shape or do.shape != qt.shape:
        raise ValueError("o and dO must have q's shape")
    if lse.dtype != torch.float32 or lse.numel() != h * n:
        raise ValueError("lse must be f32 [H, N, 1]")
    if d not in HEAD_DIMS_CUDA:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS_CUDA}")
    do = do.contiguous()  # autograd hands the transposed view of the caller's grad
    tensors = (qt, kt, vt, o, lse, do)
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("q, k, v, o, lse must be contiguous")
    if any(x.device != qt.device for x in tensors):
        raise ValueError("q, k, v, o, lse, dO must be on one device")
    if any(x.data_ptr() % 16 for x in tensors):
        raise ValueError("q, k, v, o, lse, dO must start on 16-byte boundaries")
    dq, dk, dv = torch.empty_like(qt), torch.empty_like(kt), torch.empty_like(vt)
    # delta, then the tensor-core body's lse, each [H, N padded to BWD_PAD_ROWS]
    padded = -(-n // BWD_PAD_ROWS) * BWD_PAD_ROWS
    scratch = torch.empty(2 * h * padded, dtype=torch.float32, device=qt.device)
    lib = _build.load()
    P = _build.ptr
    rc = _build.launch(qt.device, lib.dtpu_flash_bwd,
        P(qt), P(kt), P(vt), P(o), P(lse), P(do), P(dq), P(dk), P(dv), P(scratch),
        h, n, kt.shape[1], d, _DTYPES[qt.dtype], int(bool(causal)), float(scale),
    )
    _build.check(rc, "dtpu_flash_bwd")
    flash_backward_cuda.launches += 1
    return dq, dk, dv


flash_backward_cuda.launches = 0  # calls that launched the kernels (one a backward)


def flash_backward(qt, kt, vt, o, lse, do, causal: bool, scale: float, block_q: int = 128):
    """``[H, N, D]`` backward -> (dQ, dK, dV): the plain version for CPU
    tensors, the hand kernel otherwise (which raises off CUDA).
    ``block_q`` is the plain version's chunk; the kernel picks its own
    tiles."""
    if qt.device.type == "cpu":
        return flash_backward_reference(qt, kt, vt, o, lse, do, causal, scale, block_q)
    return flash_backward_cuda(qt, kt, vt, o, lse, do, causal, scale)


class _FlashAttention(torch.autograd.Function):
    """Forward then recompute backward, as the reference's ``_flash_diff``
    ``custom_vjp``: on CUDA K2 then K3, on the CPU the plain pair.
    Saves ``q, k, v`` and the forward's O (input dtype) and lse.  Once
    differentiable: lse is saved, not an output, so a second derivative
    through it would be wrong, and differentiating twice raises."""

    @staticmethod
    def forward(ctx, qt, kt, vt, causal, scale, block_q):
        o, lse = flash_forward(qt, kt, vt, causal, scale)
        ctx.save_for_backward(qt, kt, vt, o, lse)
        ctx.causal, ctx.scale, ctx.block_q = causal, scale, block_q
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        qt, kt, vt, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(qt, kt, vt, o, lse, do, ctx.causal, ctx.scale,
                                    ctx.block_q)
        return dq, dk, dv, None, None, None


def flash_attention(
    q, k, v, *, causal: bool = False, scale: float | None = None,
    block_q: int = 128, block_k: int = 128, device=None,
):
    """Flash attention over ``[seq, heads, dim]`` inputs on one device.

    Differentiable: ``torch.autograd`` flows through it (the forward
    kernel, then the recompute backward from the saved lse), to the
    caller's tensors as well when ``torch.as_tensor`` moves them to
    ``device``.  Blocks clamp to the sequence length and the sequence
    must divide by the clamped blocks, as in the reference (whose tiles
    they are, and ``block_q`` the plain backward's chunk; the kernels
    pick their own tiles and mask ragged edges).  ``device=None`` means
    CUDA.  Returns O in the input dtype.
    """
    dev = resolve_device(device)
    q, k, v = (torch.as_tensor(x, device=dev) for x in (q, k, v))
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    n, nk = q.shape[0], k.shape[0]
    block_q = min(block_q, n)
    block_k = min(block_k, nk)
    if n % block_q or nk % block_k:
        raise ValueError(
            f"seq lengths ({n}, {nk}) must divide by blocks "
            f"({block_q}, {block_k})"
        )
    qt, kt, vt = (x.transpose(0, 1).contiguous() for x in (q, k, v))
    out = _FlashAttention.apply(qt, kt, vt, bool(causal), float(scale), block_q)
    return out.transpose(0, 1)


def reference_attention(q, k, v, causal: bool = False, scale: float | None = None):
    """O(N^2)-memory single-device oracle over ``[seq, heads, dim]``."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("qhd,khd->hqk", q, k) * scale
    if causal:
        n, nk = q.shape[0], k.shape[0]
        mask = torch.arange(n)[:, None] >= torch.arange(nk)[None, :]
        s = torch.where(mask.to(s.device)[None], s, _NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,khd->qhd", p, v).to(q.dtype)
