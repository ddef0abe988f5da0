"""Flash attention forward, PyTorch + CUDA port.

The counterpart of ``distributed_tpu/ops/flash.py``: tiled
online-softmax attention that never holds the ``[N, Nk]`` score matrix.
The forward runs the hand-written kernel ``csrc/flash_fwd.cu`` on CUDA
tensors and :func:`flash_forward_reference`, the same math in plain torch
ops, on CPU tensors.  Layout, defaults, block clamping, the ``-1e30``
mask and the ``[H, N, 1]`` f32 logsumexp follow the reference.

The kernel has two bodies: bf16 / f16 inputs run on the tensor cores
(TMA + ``wgmma``), which round P once to the input type before P.V;
f32 inputs run on the CUDA cores in f32.  :func:`pv_rounding_term`
gives the error bound that rounding of P implies.

Forward only: the reference's recompute backward (``_flash_diff_bwd``)
comes with a later slice as a hand kernel inside an autograd Function.
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


def flash_forward_reference(qt, kt, vt, causal: bool, scale: float):
    """Plain version: ``[H, N, D]`` inputs -> (O in q's dtype, lse f32
    ``[H, N, 1]``), in f32, with one tile spanning the whole sequence."""
    q = qt.to(torch.float32) * scale
    s = torch.matmul(q, kt.to(torch.float32).transpose(-1, -2))  # [H, N, Nk]
    if causal:
        n, nk = qt.shape[1], kt.shape[1]
        qpos = torch.arange(n, device=qt.device)[:, None]
        kpos = torch.arange(nk, device=qt.device)[None, :]
        s = torch.where(qpos >= kpos, s, _NEG)
    m = torch.clamp_min(s.amax(dim=-1, keepdim=True), _NEG)
    p = torch.exp(s - m)
    l = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    o = torch.matmul(p, vt.to(torch.float32)) / l
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
    rc = lib.dtpu_flash_fwd(
        P(qt), P(kt), P(vt), P(o), P(lse),
        h, n, kt.shape[1], d, _DTYPES[qt.dtype], int(bool(causal)), float(scale),
        _build.stream_handle(qt.device),
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


def flash_attention(
    q, k, v, *, causal: bool = False, scale: float | None = None,
    block_q: int = 128, block_k: int = 128, device=None,
):
    """Flash attention over ``[seq, heads, dim]`` inputs on one device.

    Blocks clamp to the sequence length and the sequence must divide by
    the clamped blocks, as in the reference (whose tiles they are; the
    kernel picks its own tiles and masks ragged edges).  ``device=None``
    means CUDA.  Returns O in the input dtype.
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
    out, _lse = flash_forward(qt, kt, vt, bool(causal), float(scale))
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
