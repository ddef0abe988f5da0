"""The port's long-context gradients: ``ring_attention`` (the hand-written
ring backward, ``_RingAttention``) and ``ulysses_attention`` (autograd
through the comm interface's differentiable ``all_to_all``) against
``jax.grad`` of the reference on the conftest's 8 virtual XLA CPU devices;
the port on ``LocalShards`` of 8 CPU shards, and on ``ProcessGroupShards``
of 2 and 4 gloo ranks.

Tolerances, f32: ``rtol = atol = 1e-4`` against ``jax.grad`` of the
reference (which ``tests/test_ring_attention.py`` holds to its oracle at
2e-3).  The port's ring runs flash attention's plain backward a block on
the CPU, from the merged lse; the reference differentiates its
``lax.scan`` of ``_block_attn``: the same gradient in another order of f32
operations.  Against the plain ring's autograd (``ring_backward_reference``)
the check is the card's, ``ring_bwd_excess <= 0``.  Across process groups:
none, the gradients equal ``LocalShards``' bit for bit (the exchanges only
move data; each shard's arithmetic is the same calls on the same inputs).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tpu.ops.ici import make_mesh_1d as ref_mesh
from distributed_tpu.ops.ring_attention import ring_attention as ref_ring
from distributed_tpu.ops.ulysses import ulysses_attention as ref_ulysses
from distributed_tpu_torch.ops import comm, flash, ici, ring_attention, ulysses

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)


ROOT = Path(__file__).resolve().parents[1]
N_DEV = 8
TOL = dict(rtol=1e-4, atol=1e-4)
needs_mesh = pytest.mark.skipif(jax.device_count() < N_DEV, reason="needs the 8-device CPU mesh")


def _qkv(n=64, h=2, d=8, seed=5):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((n, h, d)).astype(np.float32) for _ in range(3))


def cpu_mesh(n=N_DEV):
    return ici.make_mesh_1d(n, axis="sp", devices=["cpu"] * n)


def _ref_grads(fn, q, k, v, **kw):
    """``jax.grad`` of ``sum(out * out)`` through the reference."""
    mesh = ref_mesh(N_DEV, axis="sp")

    def loss(q, k, v):
        out = fn(mesh, q, k, v, axis="sp", **kw)
        return (out * out).sum()

    g = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(x) for x in g]


def _port_grads(fn, q, k, v, mesh=None, **kw):
    """``torch.autograd`` of the same loss through the port, the gradients
    landing on the caller's global tensors."""
    qq, kk, vv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = torch.cat(fn(mesh or cpu_mesh(), qq, kk, vv, **kw))
    (out * out).sum().backward()
    return [x.grad.numpy() for x in (qq, kk, vv)]


@needs_mesh
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("path", ["flash_blocks", "plain"])
def test_ring_grads_equal_jax_grad(causal, path):
    """The hand-written backward (K3's plain version a block) and autograd
    through the plain ring, each against the reference's ``jax.grad``."""
    q, k, v = _qkv()
    want = _ref_grads(ref_ring, q, k, v, causal=causal)
    fn = ring_attention.ring_attention if path == "flash_blocks" else \
        ring_attention.ring_attention_reference
    got = _port_grads(fn, q, k, v, causal=causal)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, w, err_msg=f"d/d{name}", **TOL)


@needs_mesh
@pytest.mark.parametrize("path", ["flash_blocks", "plain"])
def test_ring_grads_handle_uneven_magnitudes(path):
    """Sharp, near-one-hot rows (q * 30, ``tests/test_ring_attention.py:58``):
    scores up to ~100, where an f32 lse resolves 2^-17.  The plain ring
    (autograd through the reference's recurrence) holds the elementwise
    1e-4.  The flash-style backward takes delta = rowsum(dO * O) from the
    merged O, whose weights exp(lse_b - lse) carry that resolution, and a
    near-one-hot row's dS is all cancellation, so small elements of dQ and
    dK part from ``jax.grad`` by more than 1e-4 of themselves: it is held
    normwise, max |G - G_ref| <= 1e-4 max |G_ref|."""
    q, k, v = _qkv(n=128, h=1, d=8, seed=3)
    q = q * 30.0
    want = _ref_grads(ref_ring, q, k, v)
    if path == "plain":
        got = _port_grads(ring_attention.ring_attention_reference, q, k, v)
        for g, w, name in zip(got, want, "qkv"):
            np.testing.assert_allclose(g, w, err_msg=f"d/d{name}", **TOL)
        return
    got = _port_grads(ring_attention.ring_attention, q, k, v)
    for g, w, name in zip(got, want, "qkv"):
        assert np.isfinite(g).all()
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), f"d/d{name}"


@needs_mesh
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [64, 40])
def test_ulysses_grads_equal_jax_grad(causal, n):
    """n = 64 takes flash attention's branch (its plain backward), n = 40
    the plain einsum's autograd, as the reference's ``_local_attention``."""
    q, k, v = _qkv(n=n, h=8, d=8, seed=6)
    want = _ref_grads(ref_ulysses, q, k, v, causal=causal)
    got = _port_grads(ulysses.ulysses_attention, q, k, v, causal=causal)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, w, err_msg=f"d/d{name}", **TOL)


def _ring_case(causal, seed=4, n=256, h=2, d=16):
    """Inputs, the ring's per-shard gradients and output, the plain ring's
    gradients and the bound's terms, at scale 0.25."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((n, h, d)).astype(np.float32))
                   for _ in range(4))
    mesh = cpu_mesh()
    qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
    out = ring_attention.ring_attention(mesh, qq, kk, vv, causal=causal)
    torch.autograd.backward(out, list(do.chunk(N_DEV)))
    grads = [tuple(g.chunk(N_DEV)[i] for g in (qq.grad, kk.grad, vv.grad)) for i in range(N_DEV)]
    o = torch.cat([x.detach() for x in out])
    plain = ring_attention.ring_backward_reference(mesh, q, k, v, do, causal=causal)
    terms = ring_attention.ring_bwd_rounding_terms(q, k, v, o, do, N_DEV, causal, 0.25)
    return (q, k, v, o, do), grads, plain, terms


@pytest.mark.parametrize("causal", [False, True])
def test_ring_backward_within_its_bound_of_the_plain_ring(causal):
    """The card's check, on the CPU: every shard's (dQ, dK, dV) within
    ``ring_bwd_excess <= 0`` of autograd through ``ring_attention_reference``."""
    _, grads, plain, terms = _ring_case(causal)
    for i in range(N_DEV):
        assert max(ring_attention.ring_bwd_excess(grads[i], plain[i], terms[i])) <= 0.0, i
        for g, w in zip(grads[i], plain[i]):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_bwd_bound_rejects_both_planted_faults(causal):
    (q, k, v, o, do), grads, plain, terms = _ring_case(causal)
    fault_a, fault_b = ring_attention.ring_bwd_planted_faults(q, k, v, o, do, grads, N_DEV,
                                                              causal, 0.25)
    step_out = [max(ring_attention.ring_bwd_excess(fault_a[i], plain[i], terms[i]))
                for i in range(N_DEV)]
    # every shard lost a block of dQ or of dK/dV (shard 0 under causal sees none at
    # step 1, but its own block's dK/dV passed through shard 1 then)
    assert min(step_out) > 0.0, step_out
    not_home = [max(ring_attention.ring_bwd_excess(fault_b[i], plain[i], terms[i]))
                for i in range(N_DEV)]
    assert not_home[N_DEV // 2] > 0.0
    assert max(not_home[:N_DEV // 2] + not_home[N_DEV // 2 + 1:]) <= 0.0


def test_ring_bwd_bound_needs_its_residual_term():
    """In bf16 the ring's O reaches K3 rounded to bf16 while the plain ring
    differentiates its f32 O: the bound holds with the residual term D and
    is exceeded without it (CPU, the plain versions a block; causal)."""
    n, h, d = 2048, 2, 64
    g = torch.Generator().manual_seed(12)
    q, k, v, do = (torch.randn((n, h, d), generator=g).to(torch.bfloat16) for _ in range(4))
    mesh = cpu_mesh()
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ring_attention.ring_attention(mesh, *leaves, causal=True)
    torch.autograd.backward(out, list(do.chunk(N_DEV)))
    grads = [tuple(x.grad.chunk(N_DEV)[i] for x in leaves) for i in range(N_DEV)]
    plain = ring_attention.ring_backward_reference(mesh, q, k, v, do, causal=True)
    o = torch.cat([x.detach() for x in out])
    terms = ring_attention.ring_bwd_rounding_terms(q, k, v, o, do, N_DEV, True, d ** -0.5)
    with_d = max(max(ring_attention.ring_bwd_excess(grads[i], plain[i], terms[i]))
                 for i in range(N_DEV))
    no_d = [[(t_g, t_r, torch.zeros_like(t_d), b) for t_g, t_r, t_d, b in terms[i]]
            for i in range(N_DEV)]
    without = max(max(ring_attention.ring_bwd_excess(grads[i], plain[i], no_d[i]))
                  for i in range(N_DEV))
    assert with_d <= 0.0 < without


def test_ring_backward_counts_one_k3_call_a_visible_block(monkeypatch):
    """n(n+1)/2 flash backward calls causal (the diagonal causal), n^2
    otherwise: the K3 launches a ring backward makes on the card."""
    calls = []
    orig = flash.flash_backward

    def counting(*args):
        calls.append(args[6])
        return orig(*args)

    monkeypatch.setattr(flash, "flash_backward", counting)
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv())
    for causal, want in ((True, N_DEV * (N_DEV + 1) // 2), (False, N_DEV * N_DEV)):
        calls.clear()
        out = ring_attention.ring_attention(cpu_mesh(), q, k, v, causal=causal)
        torch.cat(out).sum().backward()
        assert len(calls) == want and sum(calls) == (N_DEV if causal else 0)
    calls.clear()
    q8, k8, v8 = (torch.from_numpy(x).requires_grad_() for x in _qkv(h=8))
    torch.cat(ulysses.ulysses_attention(cpu_mesh(), q8, k8, v8, causal=True)).sum().backward()
    assert calls == [True] * N_DEV  # one a head group


def test_ring_backward_repeats_bit_for_bit():
    q, k, v = (torch.from_numpy(x) for x in _qkv())
    runs = []
    for _ in range(2):
        qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
        torch.cat(ring_attention.ring_attention(cpu_mesh(), qq, kk, vv, causal=True)).sum().backward()
        runs.append([x.grad for x in (qq, kk, vv)])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("shift", [1, -1, 3])
def test_local_shards_ppermute_and_all_to_all_are_differentiable(shift):
    """Autograd through ``LocalShards``' collectives gives the transposes:
    ``ppermute(-shift)`` and ``all_to_all`` of the gradient."""
    n = 4
    local = comm.LocalShards(cpu_mesh(n))
    rng = np.random.default_rng(1)
    xs = [torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32)).requires_grad_()
          for _ in range(n)]
    ws = [torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32)) for _ in range(n)]
    sum((y * w).sum() for y, w in zip(local.ppermute(xs, shift), ws)).backward()
    for x, g in zip(xs, local.ppermute(ws, -shift)):
        assert torch.equal(x.grad, g)
        x.grad = None
    sum((y * w).sum() for y, w in zip(local.all_to_all(xs), ws)).backward()
    for x, g in zip(xs, local.all_to_all(ws)):
        assert torch.equal(x.grad, g)


# ------------------------------------------------------------ process groups


def rank_grads(c, mesh, n):
    """What a holder of ``c.local`` computes: the ring's gradients (causal
    and not), Ulysses' and the raw collectives', per shard it holds."""
    rng = np.random.default_rng(21)
    q, k, v = (torch.from_numpy(rng.standard_normal((16 * n, 4, 8)).astype(np.float32))
               for _ in range(3))
    w = torch.from_numpy(rng.standard_normal((16 * n, 4, 8)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((n, n, 3)).astype(np.float32))
    out = {}
    for label, fn, causal in (("ring", ring_attention.ring_attention, False),
                              ("ring_causal", ring_attention.ring_attention, True),
                              ("ulysses", ulysses.ulysses_attention, True)):
        parts = [ici.local_parts(mesh, c, t) for t in (q, k, v)]
        leaves = [[p.clone().requires_grad_() for p in ps] for ps in parts]
        o = fn(mesh, *leaves, causal=causal, comm=c)
        ws = ici.local_parts(mesh, c, w)
        sum((a * b).sum() for a, b in zip(o, ws)).backward()
        for j, d in enumerate(c.local):
            for name, ps in zip("qkv", leaves):
                out[(d, f"{label}_d{name}")] = ps[j].grad
    xs = [x[d].clone().requires_grad_() for d in c.local]
    ys = c.all_to_all(c.ppermute(xs, 1))
    sum((y * (d + 1)).sum() for y, d in zip(ys, c.local)).backward()
    for j, d in enumerate(c.local):
        out[(d, "collectives_dx")] = xs[j].grad
    return out


_RANK = r"""
import sys
import numpy as np, torch
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from distributed_tpu_torch.ops import ici
from distributed_tpu_torch.ops.comm import ProcessGroupShards
from distributed_tpu_torch.parallel import multihost
import test_torch_long_context_grad as t
torch.set_num_threads(1)
rank, n = int(sys.argv[1]), {n}
assert multihost.maybe_initialize("localhost:{port}", rank, n, backend="gloo")
try:
    mesh = ici.make_mesh_1d(n, axis="sp", devices=["cpu"] * n)
    out = t.rank_grads(ProcessGroupShards(mesh), mesh, n)
    np.savez(sys.argv[2], **{{k[1]: v.numpy() for k, v in out.items()}})
finally:
    import torch.distributed as dist
    dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("n", [2, 4])
def test_gloo_ranks_give_local_shards_gradients(tmp_path, n):
    code = _RANK.format(root=str(ROOT), tests=str(ROOT / "tests"), port=_free_port(), n=n)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(tmp_path / f"r{r}.npz")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(n)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            p.kill()
    mesh = cpu_mesh(n)
    want = rank_grads(comm.LocalShards(mesh), mesh, n)
    for r in range(n):
        got = np.load(tmp_path / f"r{r}.npz")
        names = sorted(name for d, name in want if d == r)
        assert sorted(got.files) == names
        for name in names:
            w = want[(r, name)].numpy()
            assert got[name].shape == w.shape, name
            assert np.array_equal(got[name].view(np.uint8), w.view(np.uint8)), f"rank {r} {name}"
