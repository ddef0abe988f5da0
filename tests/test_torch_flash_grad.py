"""The port's flash-attention gradients against the JAX reference on CPU.

The reference's backward is ``_flash_diff_bwd``, the ``custom_vjp`` of its
Pallas kernel, which runs in interpret mode off-TPU; the port's is the
autograd Function ``_FlashAttention``, whose CPU path is the plain pair
``flash_forward_reference`` / ``flash_backward_reference``.  Same numpy
inputs, f32.  The two sum in other orders (one tile against the
reference's online softmax in the forward, other matmul kernels), so
values agree to about 1e-6 of gradients of order 1: TOL below.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tpu.ops import flash as jf
from distributed_tpu.ops.ring_attention import reference_attention as jref
from distributed_tpu_torch.ops import flash as tf

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)


def _arrays(*shapes, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in shapes)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n,nk", [(128, 128), (64, 128), (128, 64)])
def test_plain_backward_matches_flash_diff_bwd(causal, n, nk):
    """Identical residuals (the reference's own forward's O and lse) into
    ``_flash_diff_bwd`` and ``flash_backward_reference``, the same chunk."""
    h, d, block = 2, 16, 32
    q, k, v, do = _arrays((h, n, d), (h, nk, d), (h, nk, d), (h, n, d), seed=n + nk)
    scale = d ** -0.5
    o, lse = jf._flash_call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale,
                            block, block, True)
    want = jf._flash_diff_bwd(causal, scale, block, block, True,
                              (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse[..., 0]),
                              jnp.asarray(do))
    res = (torch.from_numpy(np.array(x)) for x in (q, k, v, o, lse, do))
    got = tf.flash_backward_reference(*res, causal, scale, block)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [8, 16, 20, 80, 96, 256])
def test_plain_backward_matches_flash_diff_bwd_at_any_head_dim(d, causal):
    """As above at the head dims the kernels run on wider instances: the
    reference's tests and dry run (8, 16), a bf16 row that is not a
    multiple of 16 bytes (20), Phi-2's, Phi-3-mini's and Gemma 2's (80, 96,
    256); seq 128, 96 keys, within TOL."""
    h, n, nk, block = 2, 128, 96, 32
    q, k, v, do = _arrays((h, n, d), (h, nk, d), (h, nk, d), (h, n, d), seed=d)
    scale = d ** -0.5
    o, lse = jf._flash_call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale,
                            block, block, True)
    want = jf._flash_diff_bwd(causal, scale, block, block, True,
                              (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse[..., 0]),
                              jnp.asarray(do))
    res = (torch.from_numpy(np.array(x)) for x in (q, k, v, o, lse, do))
    got = tf.flash_backward_reference(*res, causal, scale, block)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL, err_msg=name)


@pytest.mark.parametrize("d", [257, 384])
def test_the_backward_kernel_refuses_head_dims_past_256(d):
    """Past 256 the wrapper raises, naming the limit, on any device."""
    qt = torch.zeros(1, 64, d, dtype=torch.bfloat16)
    lse = torch.zeros(1, 64, 1)
    before = tf.flash_backward_cuda.launches
    with pytest.raises(ValueError, match=f"head dim {d} outside 1..256"):
        tf.flash_backward_cuda(qt, qt, qt, qt, lse, qt, True, 0.1)
    assert tf.flash_backward_cuda.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("d", [1, 8, 20, 80, 256])
def test_the_backward_kernel_refuses_cpu_tensors_at_every_head_dim(d, dtype):
    qt = torch.zeros(2, 64, d, dtype=dtype)
    lse = torch.zeros(2, 64, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.flash_backward_cuda(qt, qt, qt, qt, lse, qt, False, 0.1)


def _loss_grads_jax(q, k, v, causal, **kw):
    def loss(q, k, v):
        out = jf.flash_attention(q, k, v, causal=causal, **kw)
        return (out * jnp.cos(out)).sum()

    return jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))


def _loss_grads_torch(q, k, v, causal, **kw):
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tf.flash_attention(q, k, v, causal=causal, device="cpu", **kw)
    return torch.autograd.grad((out * torch.cos(out)).sum(), (q, k, v))


@pytest.mark.parametrize("causal", [False, True])
def test_gradients_match_jax_grad(causal):
    """``torch.autograd.grad`` through the port's ``flash_attention``
    against ``jax.grad`` of the reference's, as
    tests/test_ring_attention.py runs it (n=128, h=2, d=16, blocks 32)."""
    q, k, v = _arrays((128, 2, 16), (128, 2, 16), (128, 2, 16), seed=7)
    want = _loss_grads_jax(q, k, v, causal, block_q=32, block_k=32)
    got = _loss_grads_torch(q, k, v, causal, block_q=32, block_k=32)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL, err_msg=f"d/d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_gradients_cross_length(causal):
    """KV longer than Q (32 against 64), as test_flash_gradients_cross_length."""
    q, k, v = _arrays((32, 2, 16), (64, 2, 16), (64, 2, 16), seed=8)
    want = _loss_grads_jax(q, k, v, causal, block_q=32, block_k=32)
    got = _loss_grads_torch(q, k, v, causal, block_q=32, block_k=32)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL, err_msg=f"d/d{name}")


def test_gradients_match_dense_oracle():
    """The reference's dense attention under jax.grad, independently of
    its flash kernel."""
    q, k, v = _arrays((64, 3, 8), (96, 3, 8), (96, 3, 8), seed=9)
    for causal in (False, True):
        def loss(q, k, v):
            out = jref(q, k, v, causal=causal)
            return (out * jnp.cos(out)).sum()

        want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
        got = _loss_grads_torch(q, k, v, causal, block_q=32, block_k=32)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n,nk", [(6, 6), (4, 7), (7, 4)])
def test_gradcheck_in_f64(causal, n, nk):
    """The Function's formula against finite differences, in f64 (the
    plain pair computes in f64 for f64 inputs), independently of JAX."""
    g = torch.Generator().manual_seed(n * 10 + nk)
    q, k, v = (torch.randn(2, s, 4, generator=g, dtype=torch.float64, requires_grad=True)
               for s in (n, nk, nk))
    assert torch.autograd.gradcheck(
        lambda a, b, c: tf._FlashAttention.apply(a, b, c, causal, 0.7, 2), (q, k, v))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_low_precision_gradients_in_input_dtype(dtype):
    """Gradients come back in the input dtype, within a few units in the
    last place of the f32 gradients (max-normwise 2**-5 bf16, 2**-8 f16:
    flash.E2E_RTOL)."""
    q, k, v = _arrays((64, 2, 32), (64, 2, 32), (64, 2, 32), seed=10)
    lo = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    out = tf.flash_attention(*lo, causal=True, device="cpu")
    assert out.dtype == dtype
    got = torch.autograd.grad(out.float().square().sum(), lo)
    ref = [x.detach().float().requires_grad_() for x in lo]
    want = torch.autograd.grad(
        tf.flash_attention(*ref, causal=True, device="cpu").square().sum(), ref)
    for gr, w in zip(got, want):
        assert gr.dtype == dtype
        err = (gr.float() - w).abs().max().item()
        assert err <= tf.E2E_RTOL[dtype] * w.abs().max().item()


def test_gradients_reach_caller_tensors():
    """Leaves passed straight in (``torch.as_tensor`` returns them), and a
    tensor computed from a leaf, get their gradients."""
    q, k, v = (torch.from_numpy(x) for x in _arrays((32, 2, 8), (32, 2, 8), (32, 2, 8), seed=11))
    q.requires_grad_()
    base = k.clone().requires_grad_()
    v.requires_grad_()
    out = tf.flash_attention(q, base * 2.0, v, causal=True, device="cpu")
    out.sum().backward()
    assert q.grad is not None and v.grad is not None and base.grad is not None
    qd, kd, vd = (x.detach().clone().requires_grad_() for x in (q, base * 2.0, v))
    want = torch.autograd.grad(tf.reference_attention(qd, kd, vd, causal=True).sum(),
                               (qd, kd, vd))
    for g, w in zip((q.grad, base.grad / 2.0, v.grad), want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


def test_double_backward_raises():
    """The saved lse carries no graph, so differentiating the gradient
    again raises instead of returning a wrong second derivative."""
    q = torch.randn(16, 1, 8, dtype=torch.float64, requires_grad=True)
    out = tf.flash_attention(q, q, q, causal=True, device="cpu")
    (g,) = torch.autograd.grad(out.square().sum(), q, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        g.sum().backward()


def test_numpy_inputs_need_no_grad():
    q, k, v = _arrays((16, 1, 8), (16, 1, 8), (16, 1, 8), seed=12)
    out = tf.flash_attention(q, k, v, device="cpu")
    assert not out.requires_grad


def test_backward_dispatch_is_by_device():
    qt = torch.randn(1, 64, 64)
    lse = torch.zeros(1, 64, 1)
    before = tf.flash_backward_cuda.launches
    dq, dk, dv = tf.flash_backward(qt, qt, qt, qt, lse, qt, False, 0.125)
    assert tf.flash_backward_cuda.launches == before
    assert dq.shape == dk.shape == dv.shape == qt.shape
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.flash_backward_cuda(qt, qt, qt, qt, lse, qt, False, 0.125)


def _rounded_backward(res, causal, scale):
    """Emulates the tensor-core body's numerics in f32: P rounded once to
    the input type before P^T.dO, dS once before dS^T.Q and dS.K."""
    q, k = res[0], res[1]
    dt = q.dtype
    dq = torch.empty(q.shape)
    dk, dv = torch.zeros(k.shape), torch.zeros(k.shape)
    for i0, qc, dc, p, ds in tf._bwd_chunks(*res, causal, scale, 64):
        dsr = ds.to(dt).float()
        dv += p.to(dt).float().transpose(1, 2) @ dc
        dq[:, i0:i0 + qc.shape[1]] = (dsr @ k.float()) * scale
        dk += (dsr.transpose(1, 2) @ qc) * scale
    return dq.to(dt), dk.to(dt), dv.to(dt)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128, 8, 16, 20, 80, 96, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_rounding_tolerance_passes_rounding_and_rejects_faults(dtype, d, causal):
    """flash.BWD_TOL with u times the rounding terms holds for a body that
    rounds P and dS to the input type, and both planted faults break it."""
    g = torch.Generator().manual_seed(d)
    qt, kt, vt, do = (torch.randn(2, 256, d, generator=g).to(dtype) for _ in range(4))
    scale = d ** -0.5
    o, lse = tf.flash_forward_reference(qt, kt, vt, causal, scale)
    res = (qt, kt, vt, o, lse, do)
    plain = tf.flash_backward_reference(*res, causal, scale)
    terms = tf.bwd_rounding_terms(*res, causal, scale)
    got = _rounded_backward(res, causal, scale)
    assert not all(torch.equal(a, b) for a, b in zip(got, plain))  # the rounding shows
    assert max(tf.bwd_excess(got, plain, terms)) <= 0.0
    fault_a, fault_b = tf.bwd_planted_faults(*res, causal, scale, plain)
    assert min(tf.bwd_excess(fault_a, plain, terms)[1:]) > 0.0
    assert tf.bwd_excess(fault_b, plain, terms)[0] > 0.0


def test_rounding_terms_are_abs_products():
    g = torch.Generator().manual_seed(0)
    qt, kt, vt, do = (torch.randn(2, 48, 8, generator=g) for _ in range(4))
    o, lse = tf.flash_forward_reference(qt, kt, vt, True, 0.3)
    tq, tk, tv = tf.bwd_rounding_terms(qt, kt, vt, o, lse, do, True, 0.3, block_q=16)
    mask = torch.ones(48, 48).tril().bool()
    p = torch.softmax(torch.where(mask, (qt @ kt.transpose(1, 2)) * 0.3, -1e30), dim=-1)
    ds = p * (do @ vt.transpose(1, 2) - (do * o).sum(-1, keepdim=True))
    for got, want in ((tv, p.transpose(1, 2) @ do.abs()),
                      (tk, 0.3 * ds.abs().transpose(1, 2) @ qt.abs()),
                      (tq, 0.3 * ds.abs() @ kt.abs())):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------- K3's tile walk, replayed

CSRC_BWD = Path(tf.__file__).resolve().parent / "csrc" / "flash_bwd.cu"
CSRC_FWD = CSRC_BWD.with_name("flash_fwd.cu")


def _instances(src, struct):
    """{head dim of the instance: its tile constants} from the
    ``template <> struct <struct><DP> { static constexpr int a = .., b = ..; };``
    lines of a source."""
    out = {}
    for m in re.finditer(r"template <> struct " + struct + r"<(\d+)> \{ static constexpr int "
                         r"([^;]+); \};", src):
        out[int(m[1])] = {k.strip(): int(v) for k, v in (kv.split("=") for kv in m[2].split(","))}
    return out


def _k3_tiles(d):
    """(resident rows a block owns, rows of a streamed tile, the instance's
    head dim) of the tensor-core body's instance that runs head dim ``d``,
    as the source declares them."""
    src = CSRC_BWD.read_text()
    dp = tf.kernel_head_dim(d)
    stream = int(re.search(r"constexpr int kStreamRows = (\d+);", src)[1])
    return _instances(src, "BwdTiles")[dp]["kResRows"], stream, dp


def _pad_rows(x, rows):
    return torch.cat([x, x.new_zeros(x.shape[0], rows - x.shape[1], *x.shape[2:])], 1)


def _replay_k3(res, causal, scale, drop_diagonal=False):
    """K3's tensor-core body walked block by block in plain torch (f32):
    launch a's padded delta and log2 lse (+inf past N, so p is 0 there
    with no mask), launch b's k-blocks walking q-tiles from the causal
    first tile, launch c's q-blocks walking k-tiles to the causal last
    one, ragged rows zero-filled as the tensor maps load them, P and dS
    rounded once per tile to the input type.  ``drop_diagonal`` starts
    b one q-tile late and stops c one k-tile early, as a kernel off by
    one at the diagonal would."""
    q, k, v, o, lse, do = res
    dt = q.dtype
    h, n, d = q.shape
    R, S, dp = _k3_tiles(d)
    # the tensor maps zero-fill the columns past d up to the instance's
    q, k, v, o, do = (torch.nn.functional.pad(x, (0, dp - d)) for x in (q, k, v, o, do))
    nk = k.shape[1]
    log2e = 1.4426950408889634
    pn, pk = -(-n // R) * R, -(-nk // R) * R
    qf, dof = _pad_rows(q.float(), pn), _pad_rows(do.float(), pn)
    kf, vf = _pad_rows(k.float(), pk), _pad_rows(v.float(), pk)
    delta = torch.zeros(h, pn)
    delta[:, :n] = (do.float() * o.float()).sum(-1)
    lse2 = torch.full((h, pn), float("inf"))
    lse2[:, :n] = lse.reshape(h, n) * log2e
    sl2 = scale * log2e

    def rnd(x):
        return x.to(dt).float()

    dk, dv = torch.zeros(h, pk, dp), torch.zeros(h, pk, dp)
    n_qt = -(-n // S)
    for k0 in range(0, nk, R):  # b
        kb, vb = kf[:, k0:k0 + R], vf[:, k0:k0 + R]
        keys = torch.arange(k0, k0 + R)[:, None]
        t0 = k0 // S if causal else 0
        for t in range(t0 + int(drop_diagonal), n_qt):
            rows = slice(t * S, t * S + S)
            qs, ds_ = qf[:, rows], dof[:, rows]
            pt = torch.exp2(kb @ qs.transpose(1, 2) * sl2 - lse2[:, None, rows])
            if causal:
                pt = torch.where(torch.arange(t * S, t * S + S)[None, :] < keys, 0.0, pt)
            dst = pt * (vb @ ds_.transpose(1, 2) - delta[:, None, rows])
            dv[:, k0:k0 + R] += rnd(pt) @ ds_
            dk[:, k0:k0 + R] += rnd(dst) @ qs
    dq = torch.zeros(h, pn, dp)
    for q0 in range(0, n, R):  # c
        qb, dob = qf[:, q0:q0 + R], dof[:, q0:q0 + R]
        qpos = torch.arange(q0, q0 + R)[:, None]
        n_kt = -(-nk // S)
        if causal:
            n_kt = min(n_kt, -(-min(q0 + R, n) // S))
        for t in range(n_kt - int(drop_diagonal)):
            cols = slice(t * S, t * S + S)
            kpos = torch.arange(t * S, t * S + S)[None, :]
            p = torch.exp2(qb @ kf[:, cols].transpose(1, 2) * sl2
                           - lse2[:, q0:q0 + R, None])
            dead = kpos >= nk
            if causal:
                dead = dead | (qpos < kpos)
            p = torch.where(dead, 0.0, p)
            ds = p * (dob @ vf[:, cols].transpose(1, 2)
                      - delta[:, q0:q0 + R, None])
            dq[:, q0:q0 + R] += rnd(ds) @ kf[:, cols]
    return ((dq[:, :n, :d] * scale).to(dt), (dk[:, :nk, :d] * scale).to(dt),
            dv[:, :nk, :d].to(dt))


def _replay_case(dtype, d, n, nk, causal):
    rng = np.random.default_rng(n * 31 + nk + d)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, s, d)).astype(np.float32)).to(dtype)
                   for s in (n, nk, nk, n))
    scale = d ** -0.5
    o, lse = tf.flash_forward_reference(q, k, v, causal, scale)
    res = (q, k, v, o, lse, do)
    return res, scale, tf.flash_backward_reference(*res, causal, scale), \
        tf.bwd_rounding_terms(*res, causal, scale)


@pytest.mark.parametrize("n,nk", [(100, 100), (192, 64), (64, 192), (256, 512), (101, 203)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128, 24, 80, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_k3_tile_walk_replay_within_tolerance(dtype, d, causal, n, nk):
    """K3's blocks, tiles, causal bounds and padded lse, replayed on the
    CPU, land within flash.BWD_TOL (+ u times the rounding terms) of the
    plain backward, ragged and cross-length included (101: N not a
    multiple of 4)."""
    res, scale, plain, terms = _replay_case(dtype, d, n, nk, causal)
    got = _replay_k3(res, causal, scale)
    assert [g.shape for g in got] == [x.shape for x in res[:3]]
    assert max(tf.bwd_excess(got, plain, terms)) <= 0.0


@pytest.mark.parametrize("n,nk", [(256, 256), (192, 64), (101, 203)])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_k3_tile_walk_replay_without_diagonal_fails(dtype, d, n, nk):
    """The same replay, one tile off at the causal diagonal in both
    launches, breaks the check for dQ and for dK or dV."""
    res, scale, plain, terms = _replay_case(dtype, d, n, nk, True)
    excess = tf.bwd_excess(_replay_k3(res, True, scale, drop_diagonal=True), plain, terms)
    assert excess[0] > 0.0 and max(excess[1:]) > 0.0


def test_k3_scratch_padding_matches_the_kernel():
    """The wrapper pads K3's lse / delta scratch as the kernel does, to a
    multiple of the rows a block owns at every instance."""
    src = CSRC_BWD.read_text()
    assert tf.BWD_PAD_ROWS == int(re.search(r"constexpr int kPadRows = (\d+);", src)[1])
    assert all(tf.BWD_PAD_ROWS % t["kResRows"] == 0
               for t in _instances(src, "BwdTiles").values())


def test_the_kernels_instances_are_the_wrappers():
    """Both sources compile the head dims flash.HEAD_DIM_INSTANCES names,
    and a head dim runs on the smallest instance that holds it."""
    for path, struct in ((CSRC_FWD, "FwdTiles"), (CSRC_BWD, "BwdTiles")):
        assert tuple(sorted(_instances(path.read_text(), struct))) == tf.HEAD_DIM_INSTANCES
    assert [tf.kernel_head_dim(d) for d in (1, 64, 65, 128, 129, 256)] == [64, 64, 128, 128, 256,
                                                                           256]
