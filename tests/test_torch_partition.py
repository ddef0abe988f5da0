"""The port's graph partitioner (``distributed_tpu_torch/ops/partition.py``)
against the JAX reference, on the CPU.

Same inputs (numpy, seeded) through ``distributed_tpu.ops.partition`` and
the port with ``device="cpu"`` (the plain version of kernel K4).
Tolerance: none.  The labels must be equal, as must the two scalars the
rounds read (the mean edge weight and the average lane load), which the
port computes in the order XLA sums them on the CPU.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_tpu.ops import partition as jp
from distributed_tpu_torch import graphs
from distributed_tpu_torch.ops import partition as tp

from test_leveled import random_dag


def _weights(out_bytes, src, bandwidth=100e6, latency=0.001):
    """Edge weights as the scheduler's plan path makes them."""
    return (out_bytes[src] / bandwidth + latency).astype(np.float32)


def _blockwise(G):
    _, d, ob, s, t = graphs.blockwise_tensordot(G)
    return d, _weights(ob, s), s, t


def _random(T, seed):
    d, ob, s, t = random_dag(np.random.default_rng(seed), T)
    return d, _weights(ob, s), s, t


def _ragged_edges(E):
    """A random DAG trimmed to exactly E edges, E far from a power of two."""
    d, w, s, t = _random(2 * E, 40 + E)
    return d, w[:E], s[:E], t[:E]


CASES = {
    "blockwise6_w8": (lambda: _blockwise(6), 8),
    "blockwise8_w12": (lambda: _blockwise(8), 12),
    "blockwise10_w16": (lambda: _blockwise(10), 16),
    "random3000_w64": (lambda: _random(3000, 1), 64),
    "random5000_w24": (lambda: _random(5000, 2), 24),
    "random777_w3": (lambda: _random(777, 3), 3),
    "edges1025_w10": (lambda: _ragged_edges(1025), 10),
    "edges3001_w7": (lambda: _ragged_edges(3001), 7),
    "no_edges_w5": (lambda: (np.random.default_rng(4).uniform(0.1, 1, 300).astype(np.float32),
                             np.zeros(0, np.float32), np.zeros(0, np.int32),
                             np.zeros(0, np.int32)), 5),
    "one_task_w4": (lambda: (np.ones(1, np.float32), np.zeros(0, np.float32),
                             np.zeros(0, np.int32), np.zeros(0, np.int32)), 4),
    "one_lane": (lambda: _random(500, 5), 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_partition_padded_equals_reference(case):
    make, W = CASES[case]
    d, w, s, t = make()
    got = tp.partition_padded(d, w, s, t, W, device="cpu")
    want = jp.partition_padded(d, w, s, t, W)
    assert got.dtype == np.int32 and got.shape == (len(d),)
    np.testing.assert_array_equal(got, want)
    if W > 1 and len(d) > 1:
        assert 0 <= got.min() and got.max() < W


def test_empty_graph():
    empty = (np.zeros(0, np.float32), np.zeros(0, np.float32),
             np.zeros(0, np.int32), np.zeros(0, np.int32))
    assert tp.partition_padded(*empty, 4, device="cpu").shape == (0,)
    assert jp.partition_padded(*empty, 4).shape == (0,)


def _reference_scalars(d, w, W):
    """``mean_w`` and ``avg_load`` as the reference's ``run`` computes them
    inside jit, on its padded inputs."""

    @jax.jit
    def scalars(durations, weights):
        mean_w = jnp.where(weights.size > 0, weights.mean(), 1.0)
        return mean_w, jnp.maximum(durations.sum() / W, 1e-9)

    dp = np.zeros(jp._bucket(len(d)), np.float32)
    dp[: len(d)] = d
    wp = np.zeros(jp._bucket(max(len(w), 1)), np.float32)
    wp[: len(w)] = w
    return tuple(np.float32(x) for x in scalars(dp, wp))


@pytest.mark.parametrize("T,E,W", [(5000, 3001, 24), (1100, 1025, 1008), (70000, 129_999, 1024),
                                   (16384, 41472, 1024), (300, 0, 5), (3, 2, 2)])
def test_scalars_equal_reference(T, E, W):
    """The scalars equal XLA's bit for bit; numpy's pairwise sum and
    torch's sum are an ulp off on some of these inputs."""
    rng = np.random.default_rng(T + E)
    d = rng.uniform(0.01, 1.0, T).astype(np.float32)
    w = (rng.uniform(1e3, 1e7, E) / 100e6 + 0.001).astype(np.float32)
    assert tp.label_scalars(d, w, W) == _reference_scalars(d, w, W)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, 1024, 4097, 65536, 100_003])
def test_xla_sum_equals_jit_sum(n):
    rng = np.random.default_rng(n)
    x = (rng.uniform(0, 1, n) * 10.0 ** rng.integers(-3, 4, n)).astype(np.float32)
    assert tp.xla_sum(x) == np.float32(jax.jit(jnp.sum)(x))


def test_given_init_equals_partition_jax():
    """A random initial labelling through the reference's jitted rounds on
    padded inputs, and the port's rounds on the real ones."""
    d, w, s, t = _random(2000, 7)
    W = 16
    init = np.random.default_rng(7).integers(0, W, len(d)).astype(np.int32)
    TB, EB = jp._bucket(len(d)), jp._bucket(len(s))
    pad = lambda a, n, dt: np.concatenate([a, np.zeros(n - len(a), dt)])  # noqa: E731
    init_pad = np.concatenate([init, np.arange(TB - len(d)) % W]).astype(np.int32)
    want = jp.partition_jax(pad(d, TB, np.float32), pad(w, EB, np.float32),
                            pad(s, EB, np.int32), pad(t, EB, np.int32), W, init=init_pad)
    run = tp.PartitionRun(d, w, s, t, W, init=init, device="cpu")
    tp.partition_rounds(run)
    np.testing.assert_array_equal(run.result(), want[: len(d)])


@pytest.mark.parametrize("iters", [0, 1, 3])
def test_iteration_counts_equal_reference(iters):
    d, w, s, t = _blockwise(6)
    np.testing.assert_array_equal(
        tp.partition_padded(d, w, s, t, 9, iters=iters, device="cpu"),
        jp.partition_padded(d, w, s, t, 9, iters=iters),
    )


def test_numpy_engine_equals_reference():
    d, w, s, t = _random(1500, 9)
    np.testing.assert_array_equal(tp.partition_numpy(d, w, s, t, 12),
                                  jp.partition_numpy(d, w, s, t, 12))
    init = jp.block_init(d, 12)
    np.testing.assert_array_equal(tp.partition_numpy(d, w, s, t, 12, init=init),
                                  jp.partition_numpy(d, w, s, t, 12, init=init))


def test_block_init_equal_load():
    d = np.ones(100, np.float32)
    counts = np.bincount(tp.block_init(d, 10), minlength=10)
    assert (counts == 10).all()
    d2 = np.ones(100, np.float32)
    d2[:10] = 9.0
    assert np.bincount(tp.block_init(d2, 10), minlength=10)[0] < 10
    for dur in (d, d2, np.zeros(7, np.float32),
                np.random.default_rng(3).uniform(0, 2, 999).astype(np.float32)):
        np.testing.assert_array_equal(tp.block_init(dur, 6), jp.block_init(dur, 6))


def _comm_volume(labels, src, dst) -> int:
    """Unique (producer, consumer-lane) cross pairs: the peer fetches after
    replica caching."""
    cross = labels[src] != labels[dst]
    return len(set(zip(src[cross].tolist(), labels[dst[cross]].tolist())))


def test_partition_beats_blocks_and_random_and_balances():
    """On the tensordot proxy (G=10, 8 lanes: 686 against the blocks' 702
    and a random labelling's 1528)."""
    d, w, s, t = _blockwise(10)
    W = 8
    labels = tp.partition_padded(d, w, s, t, W, device="cpu")
    vol = _comm_volume(labels, s, t)
    vol_rand = _comm_volume(np.random.default_rng(0).integers(0, W, len(d)), s, t)
    assert vol < 0.5 * vol_rand
    assert vol < _comm_volume(tp.block_init(d, W), s, t)
    load = np.bincount(labels, weights=d, minlength=W)
    assert load.max() <= 1.5 * d.sum() / W


def _kernel_order(run: tp.PartitionRun) -> np.ndarray:
    """K4's arithmetic in python, one scalar add at a time: per round the
    lane loads bucketed by lane in task order, each row of the round's
    parity summed over ``run.csr()``'s in-edges then out-edges, masked,
    given its bonus and reduced to its first maximum from the old labels."""
    T, W = run.T, run.W
    d = run.host[0]
    csr = [a.numpy() for a in run.csr()]
    in_off, in_nbr, in_w, out_off, out_nbr, out_w = csr
    f32 = np.float32
    cur = run.init.numpy().copy()
    for it in range(run.iters):
        load = [f32(0.0)] * W
        for i in range(T):
            load[cur[i]] = f32(load[cur[i]] + d[i])
        blocked = [x >= f32(run.thresh) for x in load]
        nxt = cur.copy()
        for i in range(it % 2, T, 2):
            row = [f32(0.0)] * W
            for nbr, wts, off in ((in_nbr, in_w, in_off), (out_nbr, out_w, out_off)):
                for k in range(off[i], off[i + 1]):
                    row[cur[nbr[k]]] = f32(row[cur[nbr[k]]] + wts[k])
            vals = [f32(-np.inf) if blocked[x] else row[x] for x in range(W)]
            vals[cur[i]] = f32(max(vals[cur[i]], f32(0.0)) + f32(run.bonus))
            nxt[i] = int(np.argmax(vals))
        cur = nxt
    return cur


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_order_equals_plain_version(seed):
    """The kernel's order of adds (edges grouped by task, edge order kept;
    loads in task order) reproduces the plain version's dense scatters.
    Self-loops and repeated edges included; tolerance: none."""
    rng = np.random.default_rng(seed)
    T, W = 120, 6
    d, w, s, t = _random(T, 50 + seed)
    extra = rng.integers(0, T, (30, 1)).astype(np.int32)
    s = np.concatenate([s, extra[:, 0], s[:10]])
    t = np.concatenate([t, extra[:, 0], t[:10]])
    w = np.concatenate([w, rng.uniform(0, 0.02, 40).astype(np.float32)])
    run = tp.PartitionRun(d, w, s, t, W, iters=4, device="cpu")
    tp.partition_rounds(run)
    np.testing.assert_array_equal(_kernel_order(run), run.result())


def test_run_rejects_what_the_kernel_cannot_take():
    d, w, s, t = _random(50, 8)
    with pytest.raises(ValueError, match="in \\[0, 50\\)"):
        tp.PartitionRun(d, w, s, t + 50, 4, device="cpu")
    with pytest.raises(ValueError, match="2 lanes"):
        tp.PartitionRun(d, w, s, t, 1, device="cpu")
    with pytest.raises(ValueError, match="init"):
        tp.PartitionRun(d, w, s, t, 4, init=np.full(50, 4), device="cpu")
    with pytest.raises(ValueError, match="equal lengths"):
        tp.PartitionRun(d, w[:-1], s, t, 4, device="cpu")


def test_reference_engines_differ_and_the_port_keeps_both():
    """The reference's numpy engine takes the mean edge weight over the
    real edges, its jitted one over the padded ``_bucket(E)`` edges, which
    dilutes the stickiness bonus; on this input they disagree on 681 of
    3,000 labels (ROADMAP queue 3).  The port reproduces each engine."""
    d, w, s, t = _random(3000, 1)
    jitted = tp.partition_padded(d, w, s, t, 64, device="cpu")
    numpy_engine = tp.partition_numpy(d, w, s, t, 64)
    np.testing.assert_array_equal(jitted, jp.partition_padded(d, w, s, t, 64))
    np.testing.assert_array_equal(numpy_engine, jp.partition_numpy(d, w, s, t, 64))
    assert int((jitted != numpy_engine).sum()) == 681
