"""The port's device data plane (``distributed_tpu_torch/ops/ici.py``)
against the reference's (``distributed_tpu/ops/ici.py`` on the conftest's
8 virtual XLA CPU devices), on the CPU: ``LocalShards`` of 8 CPU shards.

Tolerance: none.  ``shuffle_on_mesh`` (keys, values as bytes, counts and
sent), ``compact_shuffle_output`` and ``ring_exchange`` equal the
reference's bit for bit.  K12's rule (a histogram a tile, a scan over the
tiles in tile order, the in-order rank from warp groups) is replayed in
numpy and equals the plain version bit for bit.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from distributed_tpu.ops import ici as ref
from distributed_tpu_torch.convert import numpy_from_shards, shards_from_numpy
from distributed_tpu_torch.ops import comm, ici

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)


N_DEV = 8
needs_mesh = pytest.mark.skipif(len(jax.devices()) < N_DEV, reason="needs 8 virtual devices")


def cpu_mesh(n: int = N_DEV, axis: str = "shuffle") -> ici.Mesh1D:
    return ici.make_mesh_1d(n, axis=axis, devices=["cpu"] * n)


def _bytes_equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), what


def _case(name):
    rng = np.random.default_rng(CASES.index(name))
    N = N_DEV * 64
    keys = rng.integers(0, 1 << 30, N).astype(np.int32)
    vals = rng.random((N, 4)).astype(np.float32)
    valid, cap = None, None
    if name == "valid":
        valid = rng.random(N) < 0.7
    elif name == "ragged_valid":
        valid = np.ones(N, bool)
        n_local = N // N_DEV
        for d in range(N_DEV):
            valid[d * n_local + n_local - d - 1:(d + 1) * n_local] = False
        cap = N
    elif name == "truncated":
        # every row on one destination: capacity 4 truncates (test_ici.py:54-71)
        keys = np.full(N_DEV * 16, 7, np.int32)
        vals = np.arange(N_DEV * 16, dtype=np.float32)[:, None]
        cap = 4
    elif name == "negative":
        keys = rng.integers(-(1 << 31), 1 << 31, N, dtype=np.int64).astype(np.int32)
        keys[:4] = [-1, -(1 << 31), (1 << 31) - 1, 0]
    elif name == "f16_rows":
        vals = rng.standard_normal((N, 3, 2)).astype(np.float16)
        cap = 16
    return keys, vals, valid, cap


CASES = ["uniform", "valid", "ragged_valid", "truncated", "negative", "f16_rows"]


@needs_mesh
@pytest.mark.parametrize("name", CASES)
def test_shuffle_on_mesh_equals_reference(name):
    keys, vals, valid, cap = _case(name)
    want = ref.shuffle_on_mesh(ref.make_mesh_1d(N_DEV), keys, vals, capacity=cap, valid=valid)
    got = ici.shuffle_on_mesh(cpu_mesh(), keys, vals, capacity=cap, valid=valid)
    for w, g, what in zip(want, got, ("keys_out", "values_out", "counts", "sent")):
        _bytes_equal(w, numpy_from_shards(g), what)
        assert all(p.device.type == "cpu" for p in g)
    if name == "truncated":
        assert np.asarray(want[3]).max() > 4 and numpy_from_shards(got[2]).max() > 4


@needs_mesh
def test_shuffle_on_mesh_takes_shard_lists():
    keys, vals, valid, _ = _case("valid")
    whole = ici.shuffle_on_mesh(cpu_mesh(), keys, vals, valid=valid)
    parts = ici.shuffle_on_mesh(cpu_mesh(), shards_from_numpy(keys, N_DEV),
                                shards_from_numpy(vals, N_DEV), valid=shards_from_numpy(valid, N_DEV))
    for a, b in zip(whole, parts):
        _bytes_equal(numpy_from_shards(a), numpy_from_shards(b), "list input")
    with pytest.raises(ValueError, match="shards"):
        ici.shuffle_on_mesh(cpu_mesh(), shards_from_numpy(keys, 4), shards_from_numpy(vals, 4))


@needs_mesh
@pytest.mark.parametrize("name", ["uniform", "valid", "ragged_valid", "negative"])
def test_compact_shuffle_output_equals_reference(name):
    keys, vals, valid, cap = _case(name)
    ko, vo, counts, _ = ref.shuffle_on_mesh(ref.make_mesh_1d(N_DEV), keys, vals, capacity=cap,
                                            valid=valid)
    want = ref.compact_shuffle_output(ko, vo, counts, N_DEV)
    tko, tvo, tcounts, _ = ici.shuffle_on_mesh(cpu_mesh(), keys, vals, capacity=cap, valid=valid)
    got = ici.compact_shuffle_output(tko, tvo, tcounts, N_DEV)
    assert len(got) == len(want) == N_DEV
    for d, ((wk, wv), (gk, gv)) in enumerate(zip(want, got)):
        _bytes_equal(wk, gk.numpy(), f"keys {d}")
        _bytes_equal(wv, gv.numpy(), f"values {d}")
        # routing: every row landed on mix32(key) % 8
        assert (ici._mix32(gk) % N_DEV == d).all()
    n_rows = len(keys) if valid is None else int(valid.sum())
    assert sum(len(k) for k, _ in got) == n_rows


@needs_mesh
def test_compact_shuffle_output_raises_on_truncation():
    keys, vals, _, cap = _case("truncated")
    ko, vo, counts, _ = ici.shuffle_on_mesh(cpu_mesh(), keys, vals, capacity=cap)
    with pytest.raises(ValueError, match="truncated"):
        ici.compact_shuffle_output(ko, vo, counts, N_DEV)
    rko, rvo, rcounts, _ = ref.shuffle_on_mesh(ref.make_mesh_1d(N_DEV), keys, vals, capacity=cap)
    with pytest.raises(ValueError, match="truncated"):
        ref.compact_shuffle_output(rko, rvo, rcounts, N_DEV)


def test_mix32_equals_reference_including_negative_keys():
    rng = np.random.default_rng(5)
    keys = rng.integers(-(1 << 31), 1 << 31, 10_000, dtype=np.int64).astype(np.int32)
    keys[:5] = [-1, -(1 << 31), (1 << 31) - 1, 0, 1]
    want = np.asarray(ref._mix32(keys)).astype(np.int64)
    np.testing.assert_array_equal(ici._mix32(torch.from_numpy(keys)).numpy(), want)


@needs_mesh
@pytest.mark.parametrize("shift", [1, 3, -1])
def test_ring_exchange_equals_reference_and_laps_home(shift):
    x = np.arange(N_DEV * 4 * 3, dtype=np.float32).reshape(N_DEV * 4, 3)
    rmesh = ref.make_mesh_1d(N_DEV)
    want = np.asarray(ref.ring_exchange(rmesh, x, shift=shift))
    got = ici.ring_exchange(cpu_mesh(), x, shift=shift)
    _bytes_equal(want, numpy_from_shards(got), "one step")
    z = got
    for _ in range(N_DEV - 1):
        z = ici.ring_exchange(cpu_mesh(), z, shift=shift)
    _bytes_equal(x, numpy_from_shards(z), "a full lap")
    with pytest.raises(ValueError, match="axis"):
        ici.ring_exchange(cpu_mesh(), x, axis="sp")


def test_make_mesh_1d_counts_devices_and_allows_repeats():
    mesh = ici.make_mesh_1d(devices=["cpu"] * 3, axis="sp")
    assert mesh.size == 3 and mesh.shape == {"sp": 3}
    assert ici.make_mesh_1d(2, devices=["cpu"] * 3).size == 2
    with pytest.raises(ValueError, match="devices"):
        ici.make_mesh_1d(1000, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="devices"):
        ref.make_mesh_1d(1000)


def test_local_shards_all_to_all_is_a_block_transpose():
    mesh = cpu_mesh(3)
    parts = [torch.arange(3 * 2).reshape(3, 2) + 10 * s for s in range(3)]
    recv = comm.LocalShards(mesh).all_to_all(parts)
    for d in range(3):
        for s in range(3):
            assert torch.equal(recv[d][s], parts[s][d])
    back = comm.LocalShards(mesh).ppermute(parts, 2)
    assert all(torch.equal(back[(i + 2) % 3], parts[i]) for i in range(3))


# ---------------------------------------------------------- K12's rule


def replay_k12(keys, vals, valid, n_dev, cap, tile=ici.SHUFFLE_TILE, threads=256,
               reverse_warp=None):
    """K12's bucket pass in numpy, launch by launch: the per-tile counts,
    the exclusive scan of each destination's counts over the tiles in
    tile order, then each tile 256 rows a pass, a row's rank = the tile's
    first rank + the rows of its destination in earlier warps this pass +
    the earlier lanes of its warp's group; then the zero tails.
    ``reverse_warp`` plants a fault: that warp's lanes rank backwards."""
    n = len(keys)
    dest = (ici._mix32(torch.from_numpy(keys)) % n_dev).numpy().astype(np.int64)
    if valid is not None:
        dest = np.where(valid, dest, -1)
    tiles = -(-n // tile)
    hist = np.zeros((tiles, n_dev), np.int64)
    for t in range(tiles):
        d = dest[t * tile:(t + 1) * tile]
        hist[t] = np.bincount(d[d >= 0], minlength=n_dev)
    first = np.cumsum(hist, axis=0) - hist  # exclusive, tile order
    sent = hist.sum(axis=0)
    send_k = np.full((n_dev, cap), -99, keys.dtype)
    send_v = np.full((n_dev, cap, *vals.shape[1:]), -99, vals.dtype)
    warps = threads // 32
    for t in range(tiles):
        run = first[t].copy()
        for p in range(tile // threads):
            i = t * tile + p * threads + np.arange(threads)
            d = np.where(i < n, dest[np.minimum(i, n - 1)], -2)
            wcnt = np.zeros((warps, n_dev), np.int64)
            in_warp = np.zeros(threads, np.int64)
            for w in range(warps):
                lanes = d[w * 32:(w + 1) * 32]
                same = lanes[:, None] == lanes[None, :]
                before = np.tril(same, -1).sum(axis=1)
                if w == reverse_warp:
                    before = np.triu(same, 1).sum(axis=1)
                in_warp[w * 32:(w + 1) * 32] = before
                ok = lanes >= 0
                wcnt[w] = np.bincount(lanes[ok], minlength=n_dev)
            for r in range(threads):
                if d[r] < 0:
                    continue
                w = r // 32
                rank = run[d[r]] + wcnt[:w, d[r]].sum() + in_warp[r]
                if rank < cap:
                    send_k[d[r], rank] = keys[i[r]]
                    send_v[d[r], rank] = vals[i[r]]
            run += wcnt.sum(axis=0)
    for dd in range(n_dev):
        lo = min(int(sent[dd]), cap)
        send_k[dd, lo:] = 0
        send_v[dd, lo:] = 0
    return send_k, send_v, sent.astype(np.int32)


K12_CASES = [
    # (n, n_dev, capacity, masked, value shape, dtype)
    (5000, 8, None, False, (4,), np.float32),
    (5000, 8, None, True, (5,), np.float32),        # 20-byte rows
    (4097, 3, 40, True, (2,), np.float32),          # truncated, ragged last tile
    (300, 1, None, False, (1,), np.int32),          # one destination
    (2048 * 2 + 31, 8, 700, False, (8,), np.uint8),  # 8-byte rows
    (17, 8, 16, True, (3,), np.float16),
]


@pytest.mark.parametrize("case", K12_CASES, ids=lambda c: f"n{c[0]}_d{c[1]}_cap{c[2]}_m{int(c[3])}")
def test_k12_rule_replay_equals_plain_version(case):
    n, n_dev, cap, masked, vshape, dtype = case
    rng = np.random.default_rng(n)
    keys = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(np.int32)
    vals = (rng.standard_normal((n, *vshape)) * 50).astype(dtype)
    valid = rng.random(n) < 0.75 if masked else None
    cap = cap or ici.default_capacity(n, n_dev)
    sk, sv, sent = ici.shuffle_bucket_reference(
        torch.from_numpy(keys), torch.from_numpy(vals),
        None if valid is None else torch.from_numpy(valid), n_dev, cap)
    rk, rv, rsent = replay_k12(keys, vals, valid, n_dev, cap)
    _bytes_equal(rk, sk.numpy(), "keys")
    _bytes_equal(rv, sv.numpy(), "values")
    _bytes_equal(rsent, sent.numpy(), "sent")


def test_k12_rule_replay_detects_a_warp_ranked_backwards():
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 1 << 30, 3000).astype(np.int32)
    vals = rng.random((3000, 4)).astype(np.float32)
    sk, _, _ = ici.shuffle_bucket_reference(torch.from_numpy(keys), torch.from_numpy(vals),
                                            None, 8, 800)
    rk, _, _ = replay_k12(keys, vals, None, 8, 800, reverse_warp=3)
    assert not np.array_equal(rk, sk.numpy())


def test_shuffle_bucket_routes_by_device(monkeypatch):
    """CPU shards take the plain version; any other device goes to the
    kernel, which raises without CUDA."""
    calls = []
    monkeypatch.setattr(ici, "shuffle_bucket_cuda", lambda *a, **k: calls.append(a))
    keys = [torch.zeros(10, dtype=torch.int32)]
    vals = [torch.zeros(10, 2)]
    ici.shuffle_bucket(keys, vals, None, 4, 16)
    assert calls == []
    ici.shuffle_bucket([k.to("meta") for k in keys], [v.to("meta") for v in vals], None, 4, 16)
    assert len(calls) == 1
