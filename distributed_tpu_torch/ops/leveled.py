"""Level-synchronous whole-graph placement, PyTorch + CUDA port.

The counterpart of ``distributed_tpu/ops/leveled.py``'s one-shot engine
(``place_graph_leveled``).  The host half is an own copy of the
reference's numpy pack: topological levels, the two heaviest
dependencies and three transfer costs per task, all in (level, index)
order so wave *w* is the contiguous slice ``[offsets[w], offsets[w+1])``.

The device half uploads the six level-sorted arrays once (16 B/task, the
reference's f16/i32 wire) with the wave offsets, and runs every wave of
the graph in one launch.  The reference pads waves to power-of-two
buckets and fuses runs of them into ``fori_loop`` dispatches because
``jit`` needs static shapes; here every wave runs at its true size and
writes exactly its own rows.

The waves have two implementations with one contract:

- :func:`place_wave_reference`, the reference's ``run_wave`` body
  written in torch ops, expression for expression, one wave a call (it
  is the CPU path and the plain version the kernel is held against);
- :func:`place_waves_cuda`, the hand-written kernel
  ``csrc/place_wave.cu``: one cooperative launch for a range of waves
  (its per-worker sums run in task order, as ``index_add_`` does on the
  CPU, so it reproduces the plain version on the CPU bit for bit).
  :func:`place_wave_cuda` is its one-wave form.

:func:`place_waves` and :func:`place_wave` pick by the device of the
state: CPU tensors take the plain version, anything else the kernel,
which raises off CUDA.

``SMALL_WAVE``, :func:`_bucket` and :func:`_plan_runs` are copies of the
reference's wave bucketing and run planning.  Nothing here calls them
yet: they are kept, with a parity test, for the streamed driver, which
plans its chunks with them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from distributed_tpu_torch._device import resolve_device
from distributed_tpu_torch.ops import _build

# waves whose pow2 bucket is <= this share one bucket in the reference's
# fused runs (kept for _plan_runs, which the streamed driver needs)
SMALL_WAVE = 16384

# every block of the wave kernel keeps a u64 and an i32 per worker in
# shared memory (96 KB at this limit)
MAX_WORKERS_CUDA = 8192


class PackedGraph(NamedTuple):
    """Host-side level-sorted encoding of a task graph.

    All per-task arrays are in (level, original-index) sorted order;
    ``perm[i]`` maps sorted position i back to the original task index.
    """

    perm: np.ndarray        # i32[T] original index of sorted task i
    level: np.ndarray       # i32[T] topological level, original order
    offsets: np.ndarray     # i32[L+1] level l = sorted slice [offsets[l], offsets[l+1])
    n_levels: int
    duration_s: np.ndarray  # f32[T] estimated runtime, sorted order
    heavy_s: np.ndarray     # i32[T] heaviest dep as a SORTED index (-1 none)
    heavy2_s: np.ndarray    # i32[T] 2nd-heaviest dep, SORTED index (-1 none)
    xfer_pref_s: np.ndarray  # f32[T] transfer seconds if co-located w/ heavy dep
    xfer_pref2_s: np.ndarray  # f32[T] ... if co-located w/ 2nd-heaviest dep
    xfer_all_s: np.ndarray   # f32[T] transfer seconds if placed anywhere else

    @property
    def n(self) -> int:
        return len(self.perm)


class LeveledResult(NamedTuple):
    assignment: np.ndarray   # i32[T] worker per task, ORIGINAL order
    start_time: np.ndarray   # f32[T] modeled start, original order
    occupancy: np.ndarray    # f32[W] final modeled load
    n_waves: int
    level: np.ndarray        # i32[T] topological level, original order
    choice: np.ndarray       # i8[T] 0=heavy-dep 1=2nd-dep 2=spread, orig order


# ------------------------------------------------------------- host pack


def _pack_numpy(durations, out_bytes, src, dst):
    """Vectorized Kahn peeling: levels, heavy deps, per-task dep bytes."""
    T = len(durations)
    # self-loops and out-of-range edges are ignored
    keep = (src != dst) & (src >= 0) & (src < T) & (dst >= 0) & (dst < T)
    if not keep.all():
        src = src[keep]
        dst = dst[keep]
    E = len(src)
    indeg = np.zeros(T, np.int64)
    np.add.at(indeg, dst, 1)
    dep_total = np.zeros(T, np.float64)
    src_bytes = out_bytes[src] if E else np.zeros(0, np.float32)
    np.add.at(dep_total, dst, src_bytes)
    heavy = np.full(T, -1, np.int64)
    heavy2 = np.full(T, -1, np.int64)
    if E:
        order = np.lexsort((src, -src_bytes, dst))
        dsorted = dst[order]
        first = np.ones(E, bool)
        first[1:] = dsorted[1:] != dsorted[:-1]
        heavy[dsorted[first]] = src[order][first]
        second = np.zeros(E, bool)
        second[1:] = first[:-1] & ~first[1:]
        heavy2[dsorted[second]] = src[order][second]

    # CSR adjacency grouped by src so each level touches only the
    # frontier's own out-edges: O(T+E) overall
    if E:
        eorder = np.argsort(src, kind="stable")
        dst_csr = dst[eorder]
        out_off = np.zeros(T + 1, np.int64)
        np.add.at(out_off, src + 1, 1)
        np.cumsum(out_off, out=out_off)

    level = np.full(T, -1, np.int32)
    placed = 0
    lvl = 0
    offsets = [0]
    perm_parts = []
    frontier = np.nonzero(indeg == 0)[0]
    while len(frontier):
        level[frontier] = lvl
        perm_parts.append(frontier.astype(np.int32))
        placed += len(frontier)
        offsets.append(placed)
        if E:
            starts = out_off[frontier]
            counts = out_off[frontier + 1] - starts
            total = int(counts.sum())
            if total:
                cum = np.cumsum(counts)
                idx = np.arange(total, dtype=np.int64) + np.repeat(
                    starts - (cum - counts), counts
                )
                targets = dst_csr[idx]
                np.add.at(indeg, targets, -1)
                frontier = np.unique(targets[indeg[targets] == 0])
            else:
                frontier = np.zeros(0, np.int64)
        else:
            frontier = np.zeros(0, np.int64)
        lvl += 1
    if placed != T:
        raise ValueError("graph has a cycle: %d tasks never became ready"
                         % (T - placed))
    perm = np.concatenate(perm_parts) if perm_parts else np.zeros(0, np.int32)
    return level, perm, heavy.astype(np.int32), heavy2.astype(np.int32), \
        dep_total.astype(np.float32), np.asarray(offsets, np.int32), lvl


def pack_graph(
    durations: np.ndarray,
    out_bytes: np.ndarray,
    src: np.ndarray,
    dst: np.ndarray,
    bandwidth: float = 100e6,
    latency: float = 0.001,
) -> PackedGraph:
    """O(T+E) pack: levels + heavy deps + transfer costs, level-sorted.

    ``src[i] -> dst[i]`` means dst depends on src.  ``latency`` is the
    per-remote-dependency round-trip cost added to the transfer model:
    co-location with the heavy dep saves one latency; any other
    placement pays one per dependency.
    """
    durations = np.ascontiguousarray(durations, np.float32)
    out_bytes = np.ascontiguousarray(out_bytes, np.float32)
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    T = len(durations)
    E = len(src)

    indeg = np.zeros(T, np.float32)
    if E:
        np.add.at(indeg, dst[(dst >= 0) & (dst < T)], 1.0)
    level, perm, heavy, heavy2, dep_total, offsets, n_levels = _pack_numpy(
        durations, out_bytes, src, dst
    )
    inv = np.empty(max(T, 1), np.int32)
    inv[perm] = np.arange(T, dtype=np.int32)
    heavy_p = heavy[perm]
    heavy2_p = heavy2[perm]
    heavy_s = np.where(heavy_p >= 0, inv[np.maximum(heavy_p, 0)], -1).astype(np.int32)
    heavy2_s = np.where(heavy2_p >= 0, inv[np.maximum(heavy2_p, 0)], -1).astype(np.int32)
    heavy_bytes = np.where(heavy_p >= 0, out_bytes[np.maximum(heavy_p, 0)], 0.0)
    heavy2_bytes = np.where(heavy2_p >= 0, out_bytes[np.maximum(heavy2_p, 0)], 0.0)
    dep_total_p = dep_total[perm]
    indeg_p = indeg[perm]
    inv_bw = np.float32(1.0 / bandwidth)
    extra = latency * np.maximum(indeg_p - 1.0, 0.0)
    return PackedGraph(
        perm=perm, level=level, offsets=offsets, n_levels=int(n_levels),
        duration_s=durations[perm], heavy_s=heavy_s, heavy2_s=heavy2_s,
        xfer_pref_s=(
            (dep_total_p - heavy_bytes) * inv_bw + extra
        ).astype(np.float32),
        xfer_pref2_s=(
            (dep_total_p - heavy2_bytes) * inv_bw + extra
        ).astype(np.float32),
        xfer_all_s=(
            dep_total_p * inv_bw + latency * indeg_p
        ).astype(np.float32),
    )


def _bucket(n: int, floor: int = 512) -> int:
    """Next power of two >= n (>= floor)."""
    b = floor
    while b < n:
        b *= 2
    return b


def _plan_runs(
    offsets: np.ndarray,
    bucket_fn=None,
    small: int = SMALL_WAVE,
) -> list[tuple[int, list[int]]]:
    """Group consecutive same-bucket waves into fused runs
    ``[(F, [wave, ...])]``, as the reference dispatches them: small waves
    share the ``small`` bucket, larger consecutive waves with one
    power-of-two bucket fuse too.  The one-shot driver here runs each
    wave at its true size; the streamed driver orders its chunk uploads
    by these runs."""
    if bucket_fn is None:
        bucket_fn = _bucket
    sizes = np.diff(offsets)
    runs: list[tuple[int, list[int]]] = []
    cur: list[int] = []
    cur_f = 0
    for w, f in enumerate(sizes):
        b = bucket_fn(int(f))
        target = small if b <= small else b
        if cur and target == cur_f:
            cur.append(w)
            continue
        if cur:
            runs.append((cur_f, cur))
        cur = [w]
        cur_f = target
    if cur:
        runs.append((cur_f, cur))
    return runs


def _worker_params(nthreads, occupancy0, running):
    """Host-side worker-fleet parameters."""
    occ_h = np.asarray(occupancy0, np.float32)
    thr_h = np.asarray(nthreads, np.int32)
    run_h = np.asarray(running, bool)
    W = len(occ_h)
    # i16 download only when every (assign+1)*4+choice code fits
    wide = (W + 1) * 4 + 3 > 32767
    # homogeneous idle fleet: the per-worker queue cost is a scalar
    uniform = bool(
        W > 0 and run_h.all() and np.ptp(occ_h) == 0 and np.ptp(thr_h) == 0
    )
    return wide, uniform, thr_h, run_h, occ_h


# ------------------------------------------------------------- device side


class _Wire(NamedTuple):
    """The six level-sorted task arrays as uploaded (views of one buffer)."""

    dur: torch.Tensor     # f16[T]
    heavy: torch.Tensor   # i32[T] sorted index of the heaviest dep (-1 none)
    heavy2: torch.Tensor  # i32[T]
    xp: torch.Tensor      # f16[T] transfer cost if co-located with heavy
    xp2: torch.Tensor     # f16[T] ... with heavy2
    xa: torch.Tensor      # f16[T] ... anywhere else


class _Fleet(NamedTuple):
    W: int
    inv_t: torch.Tensor    # f32[W] 1 / max(nthreads, 1)
    running: torch.Tensor  # bool[W]
    ovt0: torch.Tensor     # f32[W] occ0 / threads, +inf where not running
    w_run: int             # running workers with threads (>= 1)
    uniform: bool
    ovt_c: float           # uniform path: occ0[0] / threads[0], an f32 value
    inv_c: float           # uniform path: inv_t[0], an f32 value


def _upload(packed: PackedGraph, device: torch.device) -> _Wire:
    """One host-to-device copy of 16 B/task: i32 heavy pair, then the
    duration and three transfer costs rounded through float16."""
    T = packed.n
    host = np.empty(16 * T, np.uint8)
    host[: 4 * T].view(np.int32)[:] = packed.heavy_s
    host[4 * T: 8 * T].view(np.int32)[:] = packed.heavy2_s
    for k, arr in enumerate((packed.duration_s, packed.xfer_pref_s,
                             packed.xfer_pref2_s, packed.xfer_all_s)):
        lo = 8 * T + 2 * k * T
        host[lo: lo + 2 * T].view(np.float16)[:] = arr
    buf = torch.from_numpy(host).to(device)

    def f16(k):
        lo = 8 * T + 2 * k * T
        return buf[lo: lo + 2 * T].view(torch.float16)

    return _Wire(
        dur=f16(0),
        heavy=buf[: 4 * T].view(torch.int32),
        heavy2=buf[4 * T: 8 * T].view(torch.int32),
        xp=f16(1), xp2=f16(2), xa=f16(3),
    )


def _make_fleet(thr_h, run_h, occ_h, uniform: bool, device) -> _Fleet:
    W = len(occ_h)
    if W == 0:
        raise ValueError("placement needs at least one worker")
    nthreads = torch.from_numpy(thr_h).to(device)
    running = torch.from_numpy(run_h).to(device)
    occ0 = torch.from_numpy(occ_h).to(device)
    inv_t = 1.0 / nthreads.clamp_min(1).to(torch.float32)
    ovt0 = torch.where(running, occ0 * inv_t, float("inf"))
    inv_c = np.float32(1.0) / np.float32(max(int(thr_h[0]), 1))
    return _Fleet(
        W=W, inv_t=inv_t, running=running, ovt0=ovt0,
        w_run=max(int((run_h & (thr_h > 0)).sum()), 1),
        uniform=uniform,
        ovt_c=float(np.float32(occ_h[0]) * inv_c),
        inv_c=float(inv_c),
    )


class _KernelScratch(NamedTuple):
    """Work space of the wave kernel, sized for the run's widest wave and
    the launch's grid (one bucketing chunk per block)."""

    blocks: int              # blocks of the cooperative launch
    tl: torch.Tensor         # f32[W] tentative wave load
    wave_load: torch.Tensor  # f32[W]
    tgt: torch.Tensor        # i32[F] worker each task's work is summed on
    wt: torch.Tensor         # f32[F] that work
    sorted: torch.Tensor     # f32[F] work bucketed by worker, task order kept
    cnt: torch.Tensor        # i32[W * blocks] per-chunk counts
    start: torch.Tensor      # i32[W] bucket starts
    tot: torch.Tensor        # i32[W] bucket sizes


class LeveledRun:
    """One placement on one device: the uploaded graph and fleet, and the
    state the waves carry (``assign``/``choices`` per sorted task,
    cumulative ``load`` per worker, ``spans`` per wave)."""

    def __init__(self, packed: PackedGraph, nthreads, occupancy0, running,
                 device=None):
        self.device = resolve_device(device)
        self.packed = packed
        self.wide, uniform, thr_h, run_h, occ_h = _worker_params(
            nthreads, occupancy0, running
        )
        self.wire = _upload(packed, self.device)
        self.fleet = _make_fleet(thr_h, run_h, occ_h, uniform, self.device)
        self.occ0 = torch.from_numpy(occ_h).to(self.device)
        T, L, W = packed.n, packed.n_levels, self.fleet.W
        self.assign = torch.empty(T, dtype=torch.int32, device=self.device)
        self.choices = torch.empty(T, dtype=torch.int32, device=self.device)
        self.load = torch.empty(W, dtype=torch.float32, device=self.device)
        self.spans = torch.empty(L, dtype=torch.float32, device=self.device)
        # wave w is sorted rows [wave_offsets[w], wave_offsets[w+1]), for the kernel
        self.wave_offsets = torch.from_numpy(
            np.ascontiguousarray(packed.offsets, np.int32)
        ).to(self.device)
        self.scratch: _KernelScratch | None = None
        self.reset()

    def reset(self) -> None:
        """Back to the state before the first wave."""
        self.assign.fill_(-1)
        self.choices.fill_(2)
        self.load.copy_(self.occ0)
        self.spans.zero_()

    def kernel_scratch(self, blocks: int) -> _KernelScratch:
        """The wave kernel's work space for a launch of ``blocks`` blocks,
        made at its first launch."""
        if self.scratch is None or self.scratch.blocks != blocks:
            W = self.fleet.W
            F = int(np.diff(self.packed.offsets).max(initial=0))

            def new(n, dtype):
                return torch.empty(max(n, 1), dtype=dtype, device=self.device)

            i32, f32 = torch.int32, torch.float32
            self.scratch = _KernelScratch(
                blocks=blocks, tl=new(W, f32), wave_load=new(W, f32),
                tgt=new(F, i32), wt=new(F, f32), sorted=new(F, f32),
                cnt=new(blocks * W, i32), start=new(W, i32), tot=new(W, i32),
            )
        return self.scratch

    def wave_bounds(self, wave: int) -> tuple[int, int]:
        """(first sorted row, row count) of a wave."""
        off = self.packed.offsets
        return int(off[wave]), int(off[wave + 1] - off[wave])

    def run_waves(self, wave_fn=None) -> None:
        """Every wave in level order: by default in one call of
        :func:`place_waves` (one launch on the card), else one
        ``wave_fn(run, wave)`` a wave."""
        if wave_fn is None:
            place_waves(self, 0, self.packed.n_levels)
            return
        for wave in range(self.packed.n_levels):
            wave_fn(self, wave)

    def codes(self) -> torch.Tensor:
        """``(assign+1)*4 + choice`` per sorted task, int16 unless the
        fleet is too wide for it: the one tensor the host downloads."""
        out = (self.assign + 1) * 4 + self.choices.clamp(0, 2)
        return out if self.wide else out.to(torch.int16)

    def download(self) -> LeveledResult:
        return _finalize(
            self.packed,
            self.codes().cpu().numpy().astype(np.int32),
            self.spans.cpu().numpy(),
            self.load.cpu().numpy(),
        )


def _argmin3(c0, c1, c2):
    """Elementwise argmin over three cost rows, first minimum on ties."""
    m01 = torch.where(c0 <= c1, 0, 1)
    v01 = torch.minimum(c0, c1)
    return torch.where(v01 <= c2, m01, 2)


def _sel3(ch, a0, a1, a2):
    return torch.where(ch == 0, a0, torch.where(ch == 1, a1, a2))


def place_wave_reference(run: LeveledRun, wave: int) -> None:
    """One wave in torch ops: the plain version of the wave kernel.

    The reference's ``run_wave`` body expression for expression, each
    of its two fleet branches with its own evaluation order, so on the
    CPU it reproduces the reference bit for bit.
    """
    wire, fleet = run.wire, run.fleet
    W = fleet.W
    offset, f = run.wave_bounds(wave)
    sl = slice(offset, offset + f)
    inf = float("inf")
    dur = wire.dur[sl].float()
    heavy = wire.heavy[sl].long()
    heavy2 = wire.heavy2[sl].long()
    xp = wire.xp[sl].float()
    xp2 = wire.xp2[sl].float()
    xa = wire.xa[sl].float()

    # locality candidates: the workers holding the two heaviest deps
    pref = torch.where(heavy >= 0, run.assign[heavy.clamp_min(0)], -1)
    p = pref.clamp_min(0).long()
    ok1 = pref >= 0
    pref2 = torch.where(heavy2 >= 0, run.assign[heavy2.clamp_min(0)], -1)
    p2 = pref2.clamp_min(0).long()
    ok2 = (pref2 >= 0) & (pref2 != pref)

    # spread: priority-contiguous equal blocks over the least-loaded
    # running workers; the sort must be stable (every key ties in wave 0)
    order = torch.argsort(
        torch.where(fleet.running, run.load * fleet.inv_t, inf), stable=True
    )
    block = max((f + fleet.w_run - 1) // fleet.w_run, 1)
    rank = torch.arange(f, device=run.device)
    spread = order[(rank // block).clamp_(max=W - 1)]

    f32 = dict(dtype=torch.float32, device=run.device)
    if fleet.uniform:
        ovt_c = torch.tensor(fleet.ovt_c, **f32)
        c0 = torch.where(ok1, xp + ovt_c, inf)
        c1 = torch.where(ok2, xp2 + ovt_c, inf)
        c2 = xa + ovt_c
    else:
        c0 = torch.where(ok1, fleet.ovt0[p] + xp, inf)
        c1 = torch.where(ok2, fleet.ovt0[p2] + xp2, inf)
        c2 = fleet.ovt0[spread] + xa
    choice = _argmin3(c0, c1, c2)
    tent = _sel3(choice, p, p2, spread)
    xfer_t = _sel3(choice, xp, xp2, xa)

    # one Jacobi contention round against the tentative wave load
    tw = dur + xfer_t
    tl = torch.zeros(W, **f32).index_add_(0, tent, tw)
    if fleet.uniform:
        inv_c = torch.tensor(fleet.inv_c, **f32)
        tli = tl * inv_c
        corr = tw * inv_c
        d0 = torch.where(
            ok1, tli[p] - torch.where(p == tent, corr, 0.0) + xp + ovt_c, inf
        )
        d1 = torch.where(
            ok2, tli[p2] - torch.where(p2 == tent, corr, 0.0) + xp2 + ovt_c, inf
        )
        d2 = tli[spread] - torch.where(spread == tent, corr, 0.0) + xa + ovt_c
    else:
        s_tab = fleet.ovt0 + tl * fleet.inv_t
        corr = tw * fleet.inv_t[tent]
        d0 = torch.where(
            ok1, s_tab[p] - torch.where(p == tent, corr, 0.0) + xp, inf
        )
        d1 = torch.where(
            ok2, s_tab[p2] - torch.where(p2 == tent, corr, 0.0) + xp2, inf
        )
        d2 = s_tab[spread] - torch.where(spread == tent, corr, 0.0) + xa
    choice = _argmin3(d0, d1, d2)
    assign_w = _sel3(choice, p, p2, spread)
    xfer = _sel3(choice, xp, xp2, xa)

    wave_load = torch.zeros(W, **f32).index_add_(0, assign_w, dur + xfer)
    run.load += wave_load
    run.spans[wave] = torch.where(fleet.running, wave_load * fleet.inv_t, 0.0).max()
    run.assign[sl] = assign_w.to(torch.int32)
    run.choices[sl] = choice.to(torch.int32)


# timeline entries a wave when place_waves_cuda is given ``stamps``
WAVE_STAMPS = 9


def place_waves_cuda(run: LeveledRun, first: int, last: int, stamps=None) -> None:
    """Waves ``[first, last)`` in one cooperative launch of the
    hand-written kernel ``csrc/place_wave.cu``.

    ``stamps``, an int64 CUDA tensor of ``(last - first) * WAVE_STAMPS``,
    receives the device clock (ns) at the start of each wave and after
    each of its 8 grid barriers; ``None`` (the default) records nothing.
    """
    fleet, wire = run.fleet, run.wire
    if run.device.type != "cuda":
        raise RuntimeError(f"place_waves_cuda needs CUDA tensors, got {run.device}")
    if fleet.W > MAX_WORKERS_CUDA:
        raise ValueError(
            f"the wave kernel takes at most {MAX_WORKERS_CUDA} workers, got {fleet.W}"
        )
    L = run.packed.n_levels
    if not 0 <= first <= last <= L:
        raise ValueError(f"waves [{first}, {last}) outside [0, {L})")
    T, W = run.packed.n, fleet.W
    lib = _build.load()
    if run.scratch is None:
        blocks = ctypes.c_int(0)
        _build.check(lib.dtpu_place_waves_grid(W, int(fleet.uniform), ctypes.byref(blocks)),
                     "dtpu_place_waves_grid")
        run.kernel_scratch(blocks.value)
    sc = run.scratch
    for name, t, dtype, n in (
        ("dur", wire.dur, torch.float16, T), ("heavy", wire.heavy, torch.int32, T),
        ("heavy2", wire.heavy2, torch.int32, T), ("xp", wire.xp, torch.float16, T),
        ("xp2", wire.xp2, torch.float16, T), ("xa", wire.xa, torch.float16, T),
        ("assign", run.assign, torch.int32, T), ("choices", run.choices, torch.int32, T),
        ("load", run.load, torch.float32, W), ("spans", run.spans, torch.float32, L),
        ("inv_t", fleet.inv_t, torch.float32, W), ("running", fleet.running, torch.bool, W),
        ("ovt0", fleet.ovt0, torch.float32, W),
        ("wave_offsets", run.wave_offsets, torch.int32, L + 1),
        ("tl", sc.tl, torch.float32, W), ("wave_load", sc.wave_load, torch.float32, W),
        ("start", sc.start, torch.int32, W), ("tot", sc.tot, torch.int32, W),
        ("cnt", sc.cnt, torch.int32, W * sc.blocks),
        *((("stamps", stamps, torch.int64, (last - first) * WAVE_STAMPS),)
          if stamps is not None else ()),
    ):
        if t.dtype != dtype or t.shape != (n,) or not t.is_contiguous() or t.device != run.device:
            raise ValueError(f"place_waves_cuda: {name} must be a contiguous {dtype}[{n}] on {run.device}")
    F = int(np.diff(run.packed.offsets).max(initial=0))
    if sc.tgt.numel() < F or sc.wt.numel() < F or sc.sorted.numel() < F:
        raise ValueError(f"place_waves_cuda: scratch too small for a wave of {F} tasks")
    P = _build.ptr
    rc = lib.dtpu_place_waves(
        P(wire.dur), P(wire.heavy), P(wire.heavy2), P(wire.xp), P(wire.xp2), P(wire.xa),
        P(run.assign), P(run.choices), P(run.load), P(run.spans),
        P(fleet.inv_t), P(fleet.running), P(fleet.ovt0), P(run.wave_offsets),
        P(sc.tl), P(sc.wave_load), P(sc.tgt), P(sc.wt), P(sc.sorted),
        P(sc.cnt), P(sc.start), P(sc.tot),
        None if stamps is None else P(stamps),
        W, first, last, fleet.w_run, int(fleet.uniform), sc.blocks,
        fleet.ovt_c, fleet.inv_c,
        _build.stream_handle(run.device),
    )
    _build.check(rc, "dtpu_place_waves")
    place_waves_cuda.launches += 1


place_waves_cuda.launches = 0  # cooperative launches in this process


def place_wave_cuda(run: LeveledRun, wave: int) -> None:
    """One wave through the kernel: a launch of the range ``[wave, wave+1)``."""
    place_waves_cuda(run, wave, wave + 1)


def place_waves(run: LeveledRun, first: int, last: int) -> None:
    """Waves ``[first, last)`` on the run's device: the plain version a
    wave at a time for CPU tensors, one kernel launch otherwise (which
    raises off CUDA)."""
    if run.device.type == "cpu":
        for wave in range(first, last):
            place_wave_reference(run, wave)
    else:
        place_waves_cuda(run, first, last)


def place_wave(run: LeveledRun, wave: int) -> None:
    """One wave on the run's device, as :func:`place_waves`."""
    place_waves(run, wave, wave + 1)


def place_graph_leveled(
    packed: PackedGraph,
    nthreads,
    occupancy0,
    running,
    device=None,
) -> LeveledResult:
    """Place the whole graph: one upload, one launch for all waves, one
    download of the packed (assignment, choice) codes.

    ``device=None`` means CUDA.  To run the plain wave on the card (how
    the kernel is checked there), drive a :class:`LeveledRun` with
    ``run_waves(place_wave_reference)``.
    """
    run = LeveledRun(packed, nthreads, occupancy0, running, device=device)
    run.run_waves()
    return run.download()


def _finalize(packed: PackedGraph, codes: np.ndarray, spans_h: np.ndarray,
              load_h: np.ndarray) -> LeveledResult:
    """Unpack the downloaded codes into original task order."""
    T, L = packed.n, packed.n_levels
    assignment = np.full(T, -1, np.int32)
    choice = np.full(T, 2, np.int8)
    if T:
        assignment[packed.perm] = codes // 4 - 1
        choice[packed.perm] = (codes % 4).astype(np.int8)
    wave_start = np.concatenate([[0.0], np.cumsum(spans_h)[:-1]]).astype(np.float32)
    start_time = wave_start[np.maximum(packed.level, 0)] if L else np.zeros(T, np.float32)
    return LeveledResult(
        assignment=assignment,
        start_time=start_time,
        occupancy=load_h,
        n_waves=L,
        level=packed.level,
        choice=choice,
    )


def validate_leveled(
    packed: PackedGraph,
    result: LeveledResult,
    src: np.ndarray,
    dst: np.ndarray,
    running: np.ndarray,
) -> None:
    """Host oracle: every task placed on a running worker; every consumer
    in a strictly later level than each of its producers."""
    a = result.assignment
    if not (a >= 0).all():
        raise AssertionError("unplaced tasks")
    if not running[a].all():
        raise AssertionError("task on non-running worker")
    lv = result.level
    real = src != dst
    if not (lv[dst[real]] > lv[src[real]]).all():
        raise AssertionError("level order violated")
