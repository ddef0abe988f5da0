"""The port's long-context attention (``ops/ring_attention.py``,
``ops/ulysses.py``) against the reference's on the conftest's 8 virtual
XLA CPU devices; the port on ``LocalShards`` of 8 CPU shards.

Tolerance, in f32: ``rtol = atol = 2e-5`` against the reference (as
``tests/test_ring_attention.py`` holds the reference to its oracle), and
1e-4 on the uneven-magnitude case (``test_ring_attention.py:58``).  The
port's ring folds each block's (O, lse) from flash attention's plain
version on the CPU, where the reference folds (m, l, acc); the two orders
of f32 operations differ in the last bits only.  The plain ring
(``ring_attention_reference``) replays the reference's recurrence.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tpu.ops.ici import make_mesh_1d as ref_mesh
from distributed_tpu.ops.ring_attention import ring_attention as ref_ring
from distributed_tpu.ops.ulysses import ulysses_attention as ref_ulysses
from distributed_tpu_torch.convert import numpy_from_shards
from distributed_tpu_torch.ops import flash, ici, ring_attention, ulysses

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)


N_DEV = 8
TOL = dict(rtol=2e-5, atol=2e-5)
needs_mesh = pytest.mark.skipif(jax.device_count() < N_DEV, reason="needs the 8-device CPU mesh")


def _qkv(n=256, h=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((n, h, d)).astype(np.float32) for _ in range(3))


def cpu_mesh(n=N_DEV):
    return ici.make_mesh_1d(n, axis="sp", devices=["cpu"] * n)


def _ref(fn, q, k, v, **kw):
    mesh = ref_mesh(N_DEV, axis="sp")
    return np.asarray(fn(mesh, *(jnp.asarray(x) for x in (q, k, v)), axis="sp", **kw))


@needs_mesh
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("path", ["flash_blocks", "plain"])
def test_ring_equals_reference(causal, path):
    q, k, v = _qkv()
    want = _ref(ref_ring, q, k, v, causal=causal)
    fn = ring_attention.ring_attention if path == "flash_blocks" else \
        ring_attention.ring_attention_reference
    got = fn(cpu_mesh(), q, k, v, causal=causal)
    assert len(got) == N_DEV and got[0].shape == (256 // N_DEV, 2, 16)
    assert all(g.dtype == torch.float32 and g.device.type == "cpu" for g in got)
    np.testing.assert_allclose(numpy_from_shards(got), want, **TOL)


@needs_mesh
@pytest.mark.parametrize("path", ["flash_blocks", "plain"])
def test_ring_handles_uneven_magnitudes(path):
    q, k, v = _qkv(n=128, h=1, d=8, seed=3)
    q = q * 30.0  # sharp, near-one-hot rows
    want = _ref(ref_ring, q, k, v)
    fn = ring_attention.ring_attention if path == "flash_blocks" else \
        ring_attention.ring_attention_reference
    got = numpy_from_shards(fn(cpu_mesh(), q, k, v))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@needs_mesh
def test_ring_skips_later_blocks_under_causal(monkeypatch):
    """n(n+1)/2 flash calls causal (the diagonal causal, the rest not),
    n^2 otherwise: the launches a ring makes on the card."""
    calls = []
    orig = flash.flash_forward

    def counting(qt, kt, vt, causal, scale):
        calls.append(causal)
        return orig(qt, kt, vt, causal, scale)

    monkeypatch.setattr(flash, "flash_forward", counting)
    q, k, v = _qkv(n=64)
    ring_attention.ring_attention(cpu_mesh(), q, k, v, causal=True)
    assert len(calls) == N_DEV * (N_DEV + 1) // 2 and sum(calls) == N_DEV
    calls.clear()
    ring_attention.ring_attention(cpu_mesh(), q, k, v, causal=False)
    assert len(calls) == N_DEV * N_DEV and not any(calls)


def _ring_missing_a_step(q, k, v, n, causal, scale, step=1):
    """A planted fault: the ring's fold of each shard's visible blocks
    (flash_forward, then ``_merge``) with ring step ``step`` left out."""
    qt, kt, vt = (ring_attention._heads_first(x.chunk(n)) for x in (q, k, v))
    out = []
    for d in range(n):
        o = lse = None
        for s in range(n):
            owner = (d - s) % n
            if s != step and ring_attention._visible(d, owner, causal):
                o_b, lse_b = flash.flash_forward(qt[d], kt[owner], vt[owner],
                                                 causal and owner == d, scale)
                o, lse = ring_attention._merge(o, lse, o_b, lse_b)
        out.append(o)
    return out


@needs_mesh
@pytest.mark.parametrize("causal", [False, True])
def test_ring_bound_rejects_a_step_left_out(causal):
    """The card's check of the kernel path (``ring_excess`` with the plain
    blocks' terms) passes the ring and fails it with one step left out."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(n=256, h=2, d=16, seed=4))
    mesh = cpu_mesh()
    plain = ring_attention.ring_attention_reference(mesh, q, k, v, causal=causal)
    terms = ring_attention.ring_rounding_terms(q, k, v, N_DEV, causal, 0.25)
    comm = ici.LocalShards(mesh)
    qt, kt, vt = (ring_attention._heads_first(x.chunk(N_DEV)) for x in (q, k, v))
    good, _ = ring_attention._ring_fold(comm, N_DEV, qt, kt, vt, causal, 0.25)
    bad = _ring_missing_a_step(q, k, v, N_DEV, causal, 0.25)
    excess = [ring_attention.ring_excess(good[i].transpose(0, 1), plain[i], terms[i])
              for i in range(N_DEV)]
    fault = [ring_attention.ring_excess(bad[i].transpose(0, 1), plain[i], terms[i])
             for i in range(N_DEV)]
    assert max(excess) <= 0.0
    assert max(fault) > 0.0


@needs_mesh
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [256, 40])
def test_ulysses_equals_reference(causal, n):
    """n = 256 takes flash attention's branch, n = 40 the plain einsum."""
    q, k, v = _qkv(n=n, h=8, d=16, seed=2)
    want = _ref(ref_ulysses, q, k, v, causal=causal)
    got = ulysses.ulysses_attention(cpu_mesh(), q, k, v, causal=causal)
    assert len(got) == N_DEV and got[0].shape == (n // N_DEV, 8, 16)
    np.testing.assert_allclose(numpy_from_shards(got), want, **TOL)


@needs_mesh
def test_ulysses_rejects_indivisible_heads():
    q, k, v = _qkv(n=64, h=4, d=8)
    with pytest.raises(ValueError, match="heads"):
        ulysses.ulysses_attention(cpu_mesh(), q, k, v)
    with pytest.raises(ValueError, match="heads"):
        _ref(ref_ulysses, q, k, v)


def test_ulysses_layout_round_trips():
    """seq_to_heads then heads_to_seq is the identity, and the middle
    layout is the reference's: shard g holds heads [g*hg, (g+1)*hg) of the
    whole sequence."""
    mesh = cpu_mesh(4)
    comm = ici.LocalShards(mesh)
    x = torch.arange(32 * 8 * 3, dtype=torch.float32).reshape(32, 8, 3)
    parts = list(x.chunk(4))
    heads = ulysses.seq_to_heads(comm, parts, 4)
    for g in range(4):
        assert torch.equal(heads[g], x[:, 2 * g:2 * g + 2])
    back = ulysses.heads_to_seq(comm, heads, 4)
    assert torch.equal(torch.cat(back), x)
