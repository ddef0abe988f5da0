"""Kernel K4's work split, few-lane parity with the JAX reference, and the
router at the few-lane extreme, on the CPU.

``csrc/partition.cu`` runs every round of label propagation in one
cooperative launch.  It cannot run here, so :func:`replay` repeats its
work split in numpy, one f32 add at a time: the load phase (up to 64
lanes a stable counting sort across the grid -- per-block slices, per-warp
parts, buckets in task order -- whose buckets a warp adds in +0-padded
blocks of 512; else a warp a lane, grid-stride over the lanes and over the
block's tiles) and the rows phase (a grid-stride walk over the round's
parity, a thread, a warp or a block a task).  It must equal the plain
version bit for bit, whatever the grid, and fail when one lane's chain is
reordered.  Tolerance: none throughout.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from distributed_tpu.ops import partition as jp
from distributed_tpu_torch import graphs
from distributed_tpu_torch.ops import partition as tp

from test_leveled import random_dag

# the kernel's constants (csrc/partition.cu)
THREADS, WARPS = 256, 8
BUCKET_LANES, CHAIN_BLOCK = 64, 512
TILE = THREADS * 16
THREAD_ROW_LANES, WARP_ROW_LANES = 32, 1024
F32 = np.float32


def _chain(values, s=F32(0.0)):
    for v in values:
        s = F32(s + v)
    return s


def _load_by_buckets(cur, durations, W, blocks):
    """Every lane's load by the counting sort: block b's slice of the
    tasks, its warps' parts of that, counted per lane; bucket starts from
    the counts; each warp hands its tasks, 32 at a time, the next slots of
    their buckets after the earlier blocks' and warps' tasks; then each
    bucket added front to back in blocks of 512, padded with +0."""
    T = len(cur)
    per_block = -(-T // blocks)
    parts, cnt = [], np.zeros((blocks, W), np.int64)
    for b in range(blocks):
        lo = min(b * per_block, T)
        hi = min(lo + per_block, T)
        per_warp = -(-(hi - lo) // WARPS)
        for w in range(WARPS):
            wlo = min(lo + w * per_warp, hi)
            whi = min(wlo + per_warp, hi)
            parts.append((b, wlo, whi))
            cnt[b] += np.bincount(cur[wlo:whi], minlength=W)
    tot = cnt.sum(0)
    start = np.concatenate([[0], np.cumsum(tot)[:-1]])
    slot = np.full(T, -1, np.int64)
    cursor = {}
    for b, wlo, whi in parts:
        cursor.setdefault(b, start + cnt[:b].sum(0))
        for base in range(wlo, whi, 32):
            for i in range(base, min(base + 32, whi)):  # a chunk's ranks: task order
                slot[i] = cursor[b][cur[i]]
                cursor[b][cur[i]] += 1
    assert sorted(slot.tolist()) == list(range(T)), "the slots are not a permutation"
    bucketed = np.zeros(T, F32)
    bucketed[slot] = durations
    loads = np.zeros(W, F32)
    for lane in range(W):
        bucket = list(bucketed[start[lane]:start[lane] + tot[lane]])
        loads[lane] = _chain(bucket + [F32(0.0)] * (-len(bucket) % CHAIN_BLOCK))
    return loads


def _load_by_warp(cur, durations, lane):
    """A warp's load of ``lane``: the block's tiles of TILE tasks, 32 at a
    time, the matches of each 32 in ballot-bit order."""
    T = len(cur)
    s = F32(0.0)
    for t0 in range(0, T, TILE):
        for c in range(t0, min(t0 + TILE, T), 32):
            idx = np.arange(c, min(c + 32, T))
            s = _chain(durations[idx[cur[idx] == lane]], s)
    return s


def _lanes_by_warp(W, blocks):
    """Each warp's lanes: warp g of the grid takes g, g + 8 blocks, ..."""
    n_warps = blocks * WARPS
    return {g: list(range(g, W, n_warps)) for g in range(n_warps)}


def _units(kind, blocks):
    return blocks * {"thread": THREADS, "warp": WARPS, "block": 1}[kind]


def replay(run: tp.PartitionRun, blocks: int, unit: str | None = None,
           reorder_lane: int | None = None):
    """K4's rounds on a grid of ``blocks`` blocks: ``(labels, loads)``, the
    final labels and each round's lane loads.  ``unit`` overrides the rows
    phase's unit (by default the kernel's choice for W);
    ``reorder_lane`` adds that lane's load back to front (a planted fault)."""
    T, W = run.T, run.W
    d = run.host[0]
    in_off, in_nbr, in_w, out_off, out_nbr, out_w = (a.numpy() for a in run.csr())
    unit = unit or ("thread" if W <= THREAD_ROW_LANES else
                    "warp" if W <= WARP_ROW_LANES else "block")
    thresh, bonus = F32(run.thresh), F32(run.bonus)
    cur = run.init.numpy().copy()
    loads = []
    for r in range(run.iters):
        parity = r & 1
        load = np.zeros(W, F32)
        if W <= BUCKET_LANES:
            load = _load_by_buckets(cur, d, W, blocks)
        else:
            for lanes in _lanes_by_warp(W, blocks).values():
                for lane in lanes:
                    load[lane] = _load_by_warp(cur, d, lane)
        if reorder_lane is not None:
            load[reorder_lane] = _chain(d[cur == reorder_lane][::-1])
        loads.append(load)
        blocked = load >= thresh
        nxt = np.full(T, -1, np.int64)
        stride = 2 * blocks * THREADS  # the tasks that keep their label
        for g in range(blocks * THREADS):
            for i in range(1 - parity + 2 * g, T, stride):
                nxt[i] = cur[i]
        rows = (T - parity + 1) // 2
        n_units = _units(unit, blocks)
        for u0 in range(n_units):
            for u in range(u0, rows, n_units):
                i = parity + 2 * u
                assert nxt[i] == -1, f"task {i} walked twice"
                row = np.zeros(W, F32)
                for nbr, wts, off in ((in_nbr, in_w, in_off), (out_nbr, out_w, out_off)):
                    for k in range(off[i], off[i + 1]):
                        row[cur[nbr[k]]] = F32(row[cur[nbr[k]]] + wts[k])
                vals = np.where(blocked, F32(-np.inf), row)
                vals[cur[i]] = F32(max(vals[cur[i]], F32(0.0)) + bonus)
                nxt[i] = int(np.argmax(vals))  # the first maximum
        assert (nxt >= 0).all(), "a task was not walked"
        cur = nxt
    return cur.astype(np.int32), loads


def _weights(out_bytes, src):
    return (out_bytes[src] / 100e6 + 0.001).astype(np.float32)


def _random(T, seed):
    d, ob, s, t = random_dag(np.random.default_rng(seed), T)
    return d, _weights(ob, s), s, t


def _blockwise(G):
    _, d, ob, s, t = graphs.blockwise_tensordot(G)
    return d, _weights(ob, s), s, t


def _spread(T, seed):
    """Durations over six decades, so that a sum in another order rounds
    differently."""
    d, w, s, t = _random(T, seed)
    rng = np.random.default_rng(seed + 1)
    return (d * 10.0 ** rng.uniform(-3, 3, T)).astype(np.float32), w, s, t


def _index_add_loads(labels, durations, W):
    return torch.zeros(W).index_add_(0, torch.from_numpy(labels).long(),
                                     torch.from_numpy(durations)).numpy()


def _assert_replay_equals_plain(case, W, blocks, unit, iters=4):
    run = tp.PartitionRun(*case, W, iters=iters, device="cpu")
    labels, loads = replay(run, blocks, unit)
    tp.partition_reference(run)
    np.testing.assert_array_equal(labels, run.result())
    # each round's loads are index_add_'s over that round's labels
    for r, load in enumerate(loads):
        before = tp.PartitionRun(*case, W, iters=r, device="cpu")
        tp.partition_reference(before)
        np.testing.assert_array_equal(load, _index_add_loads(before.result(), case[0], W))


GRID_CASES = {
    "random_t1501_w2": (lambda: _spread(1501, 1), 2),
    "random_t777_w3": (lambda: _spread(777, 2), 3),
    "random_t3001_w16": (lambda: _spread(3001, 3), 16),
    "blockwise8_w16": (lambda: _blockwise(8), 16),
    "random_t401_w40": (lambda: _spread(401, 4), 40),
    "random_t1201_w100": (lambda: _spread(1201, 7), 100),
}


@pytest.mark.parametrize("blocks", [1, 2, 7, 132])
@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_replay_of_the_work_split_equals_plain(case, blocks):
    """Both load modes (the counting sort up to 64 lanes, else a warp a
    lane) and the kernel's rows unit for W, on grids of 1, 2, 7 and 132
    blocks, at odd T and W in {2, 3, 16, 40, 100}."""
    make, W = GRID_CASES[case]
    _assert_replay_equals_plain(make(), W, blocks, None)


@pytest.mark.parametrize("blocks", [1, 7, 132])
@pytest.mark.parametrize("unit", ["thread", "warp", "block"])
def test_replay_rows_units_equal_plain(unit, blocks):
    """Every rows unit walks each task of the round's parity once and
    gives the same labels."""
    _assert_replay_equals_plain(_spread(999, 5), 16, blocks, unit, iters=3)


def test_replay_wide_rows_equal_plain():
    """Past 1,024 lanes the block takes a task; a warp owns several lanes
    when they outnumber the grid's warps (1 block: 8 warps, 1,100 lanes)."""
    _assert_replay_equals_plain(_spread(301, 6), 1100, 1, None, iters=2)


@pytest.mark.parametrize("blocks", [2, 132])
def test_replay_with_a_reordered_chain_fails(blocks):
    """One lane's load added back to front: its bits differ, so the
    replay no longer equals the plain version."""
    case = _spread(3001, 3)
    W = 16
    run = tp.PartitionRun(*case, W, iters=2, device="cpu")
    _, loads = replay(run, blocks, reorder_lane=5)
    want = _index_add_loads(run.init.numpy(), case[0], W)
    assert loads[0][5] != want[5]
    with pytest.raises(AssertionError):
        np.testing.assert_array_equal(loads[0], want)


def test_padding_adds_nothing():
    """The buckets' +0 padding leaves a sum that starts at +0 unchanged:
    such a sum is never -0, and x + 0 == x for every other x."""
    rng = np.random.default_rng(0)
    for x in np.concatenate([rng.normal(0, 1e3, 1000), [0.0, np.inf, 1e-45]]).astype(F32):
        s = _chain([F32(0.0), x])
        assert not (s == 0 and np.signbit(s))
        assert F32(s + F32(0.0)).tobytes() == s.tobytes()
    assert not np.signbit(_chain([F32(0.0), F32(-0.0)]))


# ------------------------------------------------- few-lane parity with JAX


FEW_CASES = {
    "random2000": lambda: _random(2000, 11),
    "random6000": lambda: _random(6000, 12),
    "blockwise12": lambda: _blockwise(12),   # 2,016 tasks
    "blockwise16": lambda: _blockwise(16),   # 4,608 tasks
}


@pytest.mark.parametrize("W", [2, 4, 8, 16])
@pytest.mark.parametrize("case", sorted(FEW_CASES))
def test_few_lanes_equal_reference(case, W):
    d, w, s, t = FEW_CASES[case]()
    got = tp.partition_padded(d, w, s, t, W, device="cpu")
    np.testing.assert_array_equal(got, jp.partition_padded(d, w, s, t, W))


# ------------------------------------------- the router at the few-lane edge


class _Routed(BaseException):
    """Raised by a stand-in planner; not an ``Exception``, so no fallback
    of the planner under test catches it."""


def _fleet(workers, threads):
    return (np.full(workers, threads, np.int32), np.zeros(workers, np.float32),
            np.ones(workers, bool))


def _port_route(monkeypatch, T, fleet):
    """The engine the port's ``_plan_from_arrays`` picks for T tasks, with
    both planners replaced so nothing of that size runs."""
    from distributed_tpu_torch.scheduler import torch_placement as tpm

    def partition(*a, **k):
        raise _Routed("partition")

    def leveled(*a, **k):
        raise _Routed("leveled")

    monkeypatch.setattr(tpm.part, "partition_padded", partition)
    monkeypatch.setattr(tpm.planning, "plan_from_arrays", leveled)
    placement = tpm.TorchPlacement(sync=True, device="cpu")
    empty_i = np.zeros(0, np.int32)
    with pytest.raises(_Routed) as routed:
        placement._plan_from_arrays(range(T), np.ones(T, np.float32), np.ones(T, np.float32),
                                    empty_i, empty_i, *fleet,
                                    [f"w{i}" for i in range(len(fleet[0]))], 100e6, 0.001)
    return str(routed.value)


def _reference_route(monkeypatch, T, fleet):
    """The same question put to the reference's ``JaxPlacement``."""
    from distributed_tpu.ops import partition as ref_part
    from distributed_tpu.scheduler.jax_placement import JaxPlacement

    def partition(*a, **k):
        raise _Routed("partition")

    monkeypatch.setattr(ref_part, "partition_padded", partition)
    monkeypatch.setattr(ref_part, "partition_numpy", partition)
    placement = JaxPlacement(min_batch=4, min_workers=0, sync=True)

    def leveled(*a, **k):
        raise _Routed("leveled")

    monkeypatch.setattr(placement, "_get_mesh", leveled)
    empty_i = np.zeros(0, np.int32)
    with pytest.raises(_Routed) as routed:
        placement._plan_from_arrays(range(T), np.ones(T, np.float32), np.ones(T, np.float32),
                                    empty_i, empty_i, *fleet,
                                    [f"w{i}" for i in range(len(fleet[0]))], 100e6, 0.001)
    return str(routed.value)


@pytest.mark.parametrize("T,workers,threads,want", [
    (1_048_576, 4, 4, "partition"),   # bucket 2^20 x 16 lanes = 16.8M
    (1_048_577, 4, 4, "leveled"),     # bucket 2^21 x 16 lanes = 33.6M
    (2_097_152, 4, 2, "partition"),   # bucket 2^21 x 8 lanes = 16.8M
    (2_097_153, 4, 2, "leveled"),
])
def test_router_at_the_few_lane_extreme(monkeypatch, T, workers, threads, want):
    fleet = _fleet(workers, threads)
    assert _port_route(monkeypatch, T, fleet) == want
    assert _reference_route(monkeypatch, T, fleet) == want
