"""The port's hand-written CUDA kernels against their plain versions.

Needs an NVIDIA GPU and nvcc; every test here is marked ``cuda`` and
skips elsewhere.  The file imports no JAX, so on a machine with the card
and no JAX it runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from distributed_tpu_torch import graphs
from distributed_tpu_torch.ops import flash, leveled

pytestmark = pytest.mark.cuda

# O per element: |o - want| <= rtol * |want| + atol.  bf16/f16 outputs
# round one f32 result to the input dtype, so they differ from the plain
# version's by at most one unit in the last place (2**-7 resp. 2**-10 of
# the value); f32 differs only by the order of the f32 sums.
O_TOL = {torch.float32: (0.0, 1e-4), torch.float16: (2.0 ** -10, 1e-5),
         torch.bfloat16: (2.0 ** -7, 1e-5)}


def o_close(o, want, dtype):
    rtol, atol = O_TOL[dtype]
    d = (o.float() - want.float()).abs() - rtol * want.float().abs()
    return d.max().item() <= atol


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("dim", [64, 128])
@pytest.mark.parametrize("n,nk", [(100, 100), (256, 512), (192, 64), (1024, 1024)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_matches_plain(cuda, dtype, dim, n, nk, causal):
    g = torch.Generator(device=cuda).manual_seed(n * 7 + dim)
    q, k, v = (torch.randn(3, s, dim, generator=g, device=cuda).to(dtype)
               for s in (n, nk, nk))
    before = flash.flash_forward_cuda.launches
    o, lse = flash.flash_forward(q, k, v, causal, dim ** -0.5)
    torch.cuda.synchronize()
    assert flash.flash_forward_cuda.launches == before + 1
    o_p, lse_p = flash.flash_forward_reference(q, k, v, causal, dim ** -0.5)
    assert o.dtype == dtype and lse.shape == (3, n, 1)
    assert o_close(o, o_p, dtype)
    assert (lse - lse_p).abs().max().item() <= 1e-3


def test_flash_attention_entry_runs_kernel(cuda):
    q = torch.randn(256, 4, 64, device=cuda, dtype=torch.bfloat16)
    before = flash.flash_forward_cuda.launches
    out = flash.flash_attention(q, q, q, causal=True)
    assert flash.flash_forward_cuda.launches == before + 1
    want = flash.reference_attention(q.float(), q.float(), q.float(), causal=True)
    assert o_close(out, want, torch.bfloat16)


def _fleet(W, mixed):
    running = np.ones(W, bool)
    occ = np.zeros(W, np.float32)
    if mixed:
        running[:8] = False
        occ = np.random.default_rng(1).uniform(0, 5, W).astype(np.float32)
    return np.full(W, 2, np.int32), occ, running


@pytest.mark.parametrize("W,mixed", [(512, False), (512, True), (4096, True), (37, False)])
def test_wave_kernel_matches_plain(cuda, W, mixed):
    """The kernel sums per worker in task order, as index_add_ does on the
    CPU: it must reproduce the plain version there bit for bit."""
    durations, out_bytes, src, dst = graphs.random_dag(50000, seed=3)
    packed = leveled.pack_graph(durations, out_bytes, src, dst)
    fleet = _fleet(W, mixed)
    before = leveled.place_wave_cuda.launches
    got = leveled.place_graph_leveled(packed, *fleet, device=cuda)
    assert leveled.place_wave_cuda.launches == before + packed.n_levels
    leveled.validate_leveled(packed, got, src, dst, fleet[2])
    want = leveled.place_graph_leveled(packed, *fleet, device="cpu")
    for field in ("assignment", "choice", "occupancy", "start_time"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


def test_wave_kernel_sums_in_task_order(cuda):
    """One wide wave whose tasks all land on few workers, with durations
    whose sum depends on the order of the adds."""
    n = 3 * leveled.WAVE_CHUNK + 5
    rng = np.random.default_rng(0)
    durations = (rng.uniform(0, 1, n) * 10.0 ** rng.integers(-3, 4, n)).astype(np.float32)
    out_bytes = np.zeros(n, np.float32)
    packed = leveled.pack_graph(durations, out_bytes, np.zeros(0, np.int32),
                                np.zeros(0, np.int32))
    fleet = _fleet(3, False)
    got = leveled.place_graph_leveled(packed, *fleet, device=cuda)
    want = leveled.place_graph_leveled(packed, *fleet, device="cpu")
    np.testing.assert_array_equal(got.occupancy, want.occupancy)
    np.testing.assert_array_equal(got.assignment, want.assignment)


def test_wave_kernel_rejects_too_many_workers(cuda):
    packed = leveled.pack_graph(*graphs.random_dag(100, seed=0))
    W = leveled.MAX_WORKERS_CUDA + 1
    with pytest.raises(ValueError, match="at most"):
        leveled.place_graph_leveled(packed, *_fleet(W, False), device=cuda)
