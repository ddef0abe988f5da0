"""The port's flash-attention forward against the JAX reference on CPU.

The reference runs its Pallas kernel in interpret mode off-TPU; the port
runs its plain version on CPU tensors.  Same numpy inputs, f32,
atol/rtol 2e-5 (the two sum the products in different orders).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_tpu.ops import flash as jf
from distributed_tpu.ops.ring_attention import reference_attention as jref
from distributed_tpu_torch.ops import flash as tf

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(n=256, nk=None, h=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    nk = n if nk is None else nk
    return tuple(
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((n, h, d), (nk, h, d), (nk, h, d))
    )


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("nk", [256, 512])  # 512: KV longer than Q
def test_flash_matches_reference(causal, nk):
    q, k, v = _qkv(n=256, nk=nk, seed=1)
    want = jf.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, block_q=64, block_k=64)
    got = tf.flash_attention(q, k, v, causal=causal, block_q=64, block_k=64,
                             device="cpu")
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    oracle = tf.reference_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                    causal=causal)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_lse_matches_flash_call(causal):
    """lse is f32 [H, N, 1], q is scaled before the product."""
    q, k, v = _qkv(n=128, nk=256, h=3, d=8, seed=2)
    qt, kt, vt = (np.ascontiguousarray(x.transpose(1, 0, 2)) for x in (q, k, v))
    scale = 0.37
    o_want, lse_want = jf._flash_call(
        jnp.asarray(qt), jnp.asarray(kt), jnp.asarray(vt),
        causal, scale, 64, 64, True,
    )
    o, lse = tf.flash_forward(*(torch.from_numpy(x) for x in (qt, kt, vt)),
                              causal, scale)
    assert lse.shape == (3, 128, 1) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_want), **TOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_want), **TOL)


def test_reference_attention_matches_jax_oracle():
    q, k, v = _qkv(n=64, nk=96, seed=3)
    for causal in (False, True):
        want = jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
        got = tf.reference_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                     causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_blocks_clamp_and_ragged_blocks_raise():
    q, k, v = _qkv(n=100, h=1, d=8)
    with pytest.raises(ValueError, match="divide"):
        tf.flash_attention(q, k, v, block_q=64, block_k=64, device="cpu")
    # blocks clamp to the sequence: 100 with the default 128 is one block
    got = tf.flash_attention(q, k, v, device="cpu")
    want = jf.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_low_precision_returns_input_dtype():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(n=64))
    out = tf.flash_attention(q, k, v, causal=True, device="cpu")
    assert out.dtype == torch.bfloat16
    want = tf.reference_attention(q.float(), k.float(), v.float(), causal=True)
    np.testing.assert_allclose(out.float().numpy(), want.numpy(), atol=2e-2)


def test_forward_dispatch_is_by_device():
    qt = torch.zeros(1, 64, 64)
    before = tf.flash_forward_cuda.launches
    tf.flash_forward(qt, qt, qt, False, 0.125)
    assert tf.flash_forward_cuda.launches == before
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.flash_forward_cuda(qt, qt, qt, False, 0.125)


# ragged against the kernel's 128-row tiles; KV longer than Q in half
RAGGED = [(100, 100, 128), (100, 200, 100), (192, 192, 64), (192, 384, 64),
          (320, 320, 64), (320, 640, 64)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n,nk,block", RAGGED)
def test_plain_matches_reference_at_ragged_shapes(n, nk, block, d, causal):
    q, k, v = _qkv(n=n, nk=nk, h=1, d=d, seed=n + nk + d)
    want = jf.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, block_q=min(block, n), block_k=block)
    got = tf.flash_attention(q, k, v, causal=causal, block_q=min(block, n),
                             block_k=block, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _rounded_p_forward(qt, kt, vt, causal, scale):
    """Emulates the tensor-core body's numerics in f32: P rounded once to
    the input type before P.V, l from the unrounded P, O rounded once."""
    s = (qt.float() * scale) @ kt.float().transpose(-1, -2)
    if causal:
        n, nk = qt.shape[1], kt.shape[1]
        s = torch.where(torch.arange(n)[:, None] >= torch.arange(nk)[None, :], s, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = (p.to(qt.dtype).float() @ vt.float()) / l
    return o.to(qt.dtype)


# the head dims of the reference's tests and dry run (8, 16), a bf16 row
# that is not a multiple of 16 bytes (20), Phi-2's (80), Phi-3-mini's (96)
# and Gemma 2's (256): the kernels run them on the instances 64, 128, 256
HEAD_DIMS = [8, 16, 20, 80, 96, 256]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n,nk", [(128, 128), (64, 128)])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_plain_forward_matches_flash_call_at_any_head_dim(d, n, nk, causal):
    """The plain version against the reference's Pallas kernel (interpret
    mode) at head dims other than 64 and 128: O and lse within TOL."""
    q, k, v = _qkv(n=n, nk=nk, h=2, d=d, seed=d + n)
    qt, kt, vt = (np.ascontiguousarray(x.transpose(1, 0, 2)) for x in (q, k, v))
    scale = d ** -0.5
    o_want, lse_want = jf._flash_call(jnp.asarray(qt), jnp.asarray(kt), jnp.asarray(vt),
                                      causal, scale, 64, 64, True)
    o, lse = tf.flash_forward_reference(*(torch.from_numpy(x) for x in (qt, kt, vt)), causal, scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_want), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_want), **TOL)


@pytest.mark.parametrize("d", [257, 264, 512])
def test_the_forward_kernel_refuses_head_dims_past_256(d):
    """Past 256 the wrapper raises, naming the limit, on any device."""
    qt = torch.zeros(1, 64, d, dtype=torch.bfloat16)
    before = tf.flash_forward_cuda.launches
    with pytest.raises(ValueError, match=f"head dim {d} outside 1..256"):
        tf.flash_forward_cuda(qt, qt, qt, True, 0.1)
    assert tf.flash_forward_cuda.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("d", [1, 8, 20, 80, 256])
def test_the_forward_kernel_refuses_cpu_tensors_at_every_head_dim(d, dtype):
    qt = torch.zeros(2, 64, d, dtype=dtype)
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.flash_forward_cuda(qt, qt, qt, False, 0.1)


@pytest.mark.parametrize("d", [1, 8, 20, 80, 93, 256])
def test_tensor_core_inputs_have_16_byte_rows(d):
    """TMA wants rows of a multiple of 16 bytes: in bf16 / f16 the kernels'
    inputs are zero-padded to the next multiple of 8 columns (their own
    values kept), f32 inputs go in as they are."""
    rng = np.random.default_rng(d)
    xs = tuple(torch.from_numpy(rng.standard_normal((2, 64, d)).astype(np.float32))
               for _ in range(3))
    assert all(a is b for a, b in zip(tf._tma_head_dim(xs), xs))
    for dtype in (torch.bfloat16, torch.float16):
        low = tuple(x.to(dtype) for x in xs)
        got = tf._tma_head_dim(low)
        width = -(-d // 8) * 8
        assert all(g.shape == (2, 64, width) and g.dtype == dtype and g.is_contiguous()
                   and g.shape[-1] * g.element_size() % 16 == 0 for g in got)
        assert all(torch.equal(g[..., :d], x) and not g[..., d:].any() for g, x in zip(got, low))
        if d % 8 == 0:
            assert all(g is x for g, x in zip(got, low))


def test_the_dry_runs_ring_runs_the_references_shapes(monkeypatch):
    """``dryrun_multichip(8, device="cpu")`` rings the reference's own
    inputs (``__graft_entry__.py``: seq 8 x 16, 2 heads, head dim 8, from
    ``default_rng(2)``), and its output holds the reference's assertion
    against the reference's oracle (rtol = atol = 5e-4)."""
    from distributed_tpu_torch import entry
    from distributed_tpu_torch.ops import ring_attention as port_ring

    seen = []
    ring = port_ring.ring_attention

    def spy(mesh, q, k, v, **kw):
        out = ring(mesh, q, k, v, **kw)
        seen.append((q, k, v, out, kw))
        return out

    monkeypatch.setattr(port_ring, "ring_attention", spy)
    assert "ring attention seq 128 over 8 shards" in entry.dryrun_multichip(8, device="cpu")
    ((q, k, v, out, kw),) = seen
    rq = np.random.default_rng(2)
    want_qkv = [rq.standard_normal((128, 2, 8)).astype(np.float32) for _ in range(3)]
    for got, want in zip((q, k, v), want_qkv):
        assert np.array_equal(got.numpy(), want)
    assert kw["causal"] is True
    want = jref(*(jnp.asarray(x) for x in want_qkv), causal=True)
    np.testing.assert_allclose(torch.cat(out).numpy(), np.asarray(want), rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128, *HEAD_DIMS])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_rounded_p_tolerance_passes_rounding_and_rejects_fault(dtype, d, causal):
    """|o - o_plain| <= rtol|o_plain| + u (P|V|)/l + atol holds for a kernel
    that rounds P to the input type, and a 64-key hole in P.V breaks it."""
    rng = np.random.default_rng(d)
    qt, kt, vt = (torch.from_numpy(rng.standard_normal((2, 256, d)).astype(np.float32)).to(dtype)
                  for _ in range(3))
    scale = d ** -0.5
    o_p, lse_p = tf.flash_forward_reference(qt, kt, vt, causal, scale)
    pv = tf.P_ROUNDOFF[dtype] * tf.pv_rounding_term(qt, kt, vt, causal, scale, lse_p)
    o_k = _rounded_p_forward(qt, kt, vt, causal, scale)
    assert not torch.equal(o_k, o_p)  # the rounding of P is visible
    assert tf.o_excess(o_k, o_p, pv) <= 0.0
    lo, hi = 128, 192
    s = (qt.float() * scale) @ kt[:, lo:hi].float().transpose(1, 2)
    if causal:
        s = s.masked_fill(torch.arange(256)[:, None] < torch.arange(lo, hi)[None, :],
                          float("-inf"))
    fault = (o_p.float() - torch.exp(s - lse_p) @ vt[:, lo:hi].float()).to(dtype)
    assert tf.o_excess(fault, o_p, pv) > 0.0


def test_pv_rounding_term_is_p_times_abs_v():
    q, k, v = (torch.from_numpy(x.transpose(1, 0, 2).copy()) for x in _qkv(n=64, h=2, d=8))
    _, lse = tf.flash_forward_reference(q, k, v, True, 0.3)
    p = torch.softmax(torch.where(torch.ones(64, 64).tril().bool(),
                                  (q * 0.3) @ k.transpose(1, 2), -1e30), dim=-1)
    torch.testing.assert_close(tf.pv_rounding_term(q, k, v, True, 0.3, lse), p @ v.abs(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_tensor_core_wrapper_raises_on_cpu_tensors(dtype):
    qt = torch.zeros(1, 128, 128, dtype=dtype)
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.flash_forward_cuda(qt, qt, qt, True, 0.1)
