"""Level-synchronous whole-graph placement, PyTorch + CUDA port.

The counterpart of ``distributed_tpu/ops/leveled.py``'s single-device
engine: the one-shot driver (``place_graph_leveled``) and the streamed
driver the scheduler calls (``place_graph_streamed``).

The host half is the C++ pack (``native/graphpack.cpp``, the port's own
copy): topological levels, the two heaviest dependencies and three
transfer costs per task, all in (level, index) order so wave *w* is the
contiguous slice ``[offsets[w], offsets[w+1])``.  :func:`pack_graph_numpy`
is its plain version, kept for the tests.

The device half holds the six level-sorted arrays in one buffer, in one
of the reference's two wire formats: ``"f16"`` (16 B/task: i32 heavy
pair, f16 duration and costs) or ``"packed"`` (11 B/task: the heavy pair
bit-packed into an i32 and a u16, the costs as u8 log codes).  Rows are
staged in pinned host memory and copied on a side stream, a chunk at a
time; the compute stream waits on each chunk's event before it launches
the waves that read those rows.  The reference pads waves to power-of-two
buckets and fuses runs of them into ``fori_loop`` dispatches because
``jit`` needs static shapes; here every wave runs at its true size and
writes exactly its own rows.  The (assignment, choice) codes come back in
segments, packed on the compute stream and copied to pinned memory on a
side stream, and the C ``unpack_assignment`` puts them in task order.

The waves have two implementations with one contract:

- :func:`place_wave_reference`, the reference's ``run_wave`` body
  written in torch ops, expression for expression, one wave a call (it
  is the CPU path and the plain version the kernel is held against);
- :func:`place_waves_cuda`, the hand-written kernel
  ``csrc/place_wave.cu``: one cooperative launch for a range of waves
  (its per-worker sums run in task order, as ``index_add_`` does on the
  CPU, so it reproduces the plain version on the CPU bit for bit).
  :func:`place_wave_cuda` is its one-wave form.

Both decode the packed wire's u8 costs through one f32 table
(:func:`cost_table`), so they agree on that wire bit for bit too.
:func:`place_waves` and :func:`place_wave` pick by the device of the
state: CPU tensors take the plain version, anything else the kernel,
which raises off CUDA.

``SMALL_WAVE``, :func:`_bucket`, :func:`_plan_runs` and
:func:`_compute_pad` are copies of the reference's wave bucketing; the
streamed driver uses them only for the reference's rule that picks the
wire format (the packed wire while the padded size fits 21 bits).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from distributed_tpu_torch import native
from distributed_tpu_torch._device import resolve_device
from distributed_tpu_torch.ops import _build

# waves whose pow2 bucket is <= this share one bucket in the reference's
# fused runs (kept for _plan_runs and _compute_pad)
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
    spans: np.ndarray        # f32[L] modeled span of each wave (sum: makespan)


# ------------------------------------------------------------- host pack


def _pack_numpy(durations, out_bytes, src, dst):
    """Vectorized Kahn peeling: levels, heavy deps, per-task dep bytes.

    The dependency bytes are summed in f32 in edge order (``np.add.at``
    is sequential), as ``graphpack.cpp`` sums them, so this plain version
    equals the C++ pack bit for bit.  The reference's numpy fallback sums
    in f64 and differs from its own C++ pack by an ulp on tasks with
    three or more dependencies.
    """
    T = len(durations)
    # self-loops and out-of-range edges are ignored
    keep = (src != dst) & (src >= 0) & (src < T) & (dst >= 0) & (dst < T)
    if not keep.all():
        src = src[keep]
        dst = dst[keep]
    E = len(src)
    indeg = np.zeros(T, np.int64)
    np.add.at(indeg, dst, 1)
    dep_total = np.zeros(T, np.float32)
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


def _graph_arrays(durations, out_bytes, src, dst):
    return (np.ascontiguousarray(durations, np.float32),
            np.ascontiguousarray(out_bytes, np.float32),
            np.ascontiguousarray(src, np.int32),
            np.ascontiguousarray(dst, np.int32))


def pack_graph_numpy(
    durations: np.ndarray,
    out_bytes: np.ndarray,
    src: np.ndarray,
    dst: np.ndarray,
    bandwidth: float = 100e6,
    latency: float = 0.001,
) -> PackedGraph:
    """The plain version of :func:`pack_graph`: the reference's numpy
    pack.  The tests hold the C++ pack against it; nothing on the
    placement path calls it.

    Like the C++ pack, and unlike the reference's numpy fallback, the
    indegree behind the latency terms counts only the edges the levels
    use: no self-loops, no edge from a source outside the graph.
    """
    durations, out_bytes, src, dst = _graph_arrays(durations, out_bytes, src, dst)
    T = len(durations)

    keep = (src != dst) & (src >= 0) & (src < T) & (dst >= 0) & (dst < T)
    indeg = np.zeros(T, np.float32)
    np.add.at(indeg, dst[keep], 1.0)
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


def _empty_pack() -> PackedGraph:
    i32, f32 = np.zeros(0, np.int32), np.zeros(0, np.float32)
    return PackedGraph(
        perm=i32, level=i32.copy(), offsets=np.zeros(1, np.int32), n_levels=0,
        duration_s=f32, heavy_s=i32.copy(), heavy2_s=i32.copy(),
        xfer_pref_s=f32.copy(), xfer_pref2_s=f32.copy(), xfer_all_s=f32.copy(),
    )


def pack_graph(
    durations: np.ndarray,
    out_bytes: np.ndarray,
    src: np.ndarray,
    dst: np.ndarray,
    bandwidth: float = 100e6,
    latency: float = 0.001,
) -> PackedGraph:
    """O(T+E) pack: levels + heavy deps + transfer costs, level-sorted,
    in one call of the C++ ``graphpack_full``.

    ``src[i] -> dst[i]`` means dst depends on src.  ``latency`` is the
    per-remote-dependency round-trip cost added to the transfer model:
    co-location with the heavy dep saves one latency; any other
    placement pays one per dependency.  Raises ``ValueError`` on a cycle
    and ``RuntimeError`` when the host library cannot be built.
    """
    durations, out_bytes, src, dst = _graph_arrays(durations, out_bytes, src, dst)
    T = len(durations)
    if len(out_bytes) != T or len(src) != len(dst):
        raise ValueError("durations/out_bytes and src/dst must have equal lengths")
    lib = native.load()
    if T == 0:
        return _empty_pack()
    i32 = [np.empty(T, np.int32) for _ in range(4)]
    level, perm, heavy_s, heavy2_s = i32
    offsets = np.empty(T + 1, np.int32)  # the pack writes [0, n_levels]
    dur_s, xp_s, xp2_s, xa_s = (np.empty(T, np.float32) for _ in range(4))
    P = native.as_ptr
    n_levels = lib.graphpack_full(
        T, len(src), P(durations), P(out_bytes), P(src), P(dst),
        1.0 / bandwidth, float(latency),
        P(level), P(perm), P(offsets),
        P(dur_s), P(heavy_s), P(heavy2_s), P(xp_s), P(xp2_s), P(xa_s),
    )
    if n_levels < 0:
        raise ValueError("graph has a cycle")
    return PackedGraph(
        perm=perm, level=level, offsets=offsets[: n_levels + 1].copy(),
        n_levels=int(n_levels), duration_s=dur_s, heavy_s=heavy_s,
        heavy2_s=heavy2_s, xfer_pref_s=xp_s, xfer_pref2_s=xp2_s, xfer_all_s=xa_s,
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
    power-of-two bucket fuse too."""
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


def _compute_pad(T: int, runs, offsets) -> int:
    """The reference's pad past T: just enough that no fused run's
    fixed-size window reads past its buffers.  The port pads nothing;
    ``T + pad`` decides the wire format, as in the reference."""
    pad = 16
    for F, waves in runs:
        if _bucket(len(waves), floor=1) > len(waves):
            pad = max(pad, F)  # padding waves use window [T, T+F)
        for w in waves:
            pad = max(pad, int(offsets[w]) + F - T)
    return pad


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


# ------------------------------------------------------------- the wire
#
# The packed format, as the reference defines it (leveled.py:272-309):
#   - heavy + heavy2 sorted indices, 21 bits each, packed into one i32
#     (heavy+1 in the low 21 bits, the low 11 bits of heavy2+1 above) and
#     a u16 (heavy2+1's high 10 bits) = 6 B instead of 8;
#   - xp/xp2/xa as log-quantized u8: code 0 is exactly 0, else
#     x = XMIN * e^(KLOG * (code-1)), +-4.5 % relative error, saturating
#     outside [XMIN, XMAX] = 3 B instead of 6.
# Durations stay f16: they feed load sums where quantization noise
# accumulates, while the costs only feed per-task argmin comparisons.
_COST_XMIN = 1e-6
_COST_XMAX = 1e4
_COST_KLOG = float(np.log(_COST_XMAX / _COST_XMIN) / 254.0)
_PACK_LIMIT = 1 << 21  # max T+1 expressible in 21 bits


def _enc_cost(x: np.ndarray) -> np.ndarray:
    """Host-side u8 log encode; exact zero keeps code 0."""
    c = np.zeros(x.shape, np.uint8)
    nz = x > 0
    if nz.any():
        v = np.rint(
            np.log(np.maximum(x[nz], _COST_XMIN) / _COST_XMIN) / _COST_KLOG
        )
        c[nz] = np.clip(v + 1, 1, 255).astype(np.uint8)
    return c


def _enc_heavy_pair(heavy_s: np.ndarray, heavy2_s: np.ndarray):
    """(i32 low word, u16 high bits) for the packed heavy-index pair."""
    hp = (heavy_s.astype(np.int64) + 1).astype(np.uint32)
    h2p = (heavy2_s.astype(np.int64) + 1).astype(np.uint32)
    lo = (hp | ((h2p & 0x7FF) << 21)).view(np.int32)
    hi = (h2p >> 11).astype(np.uint16)
    return lo, hi


_cost_table: torch.Tensor | None = None


def cost_table() -> torch.Tensor:
    """f32[256] decode of the u8 cost codes, on the CPU: the reference's
    ``_dec_cost`` expression, ``XMIN * exp(KLOG * (c - 1))`` in f32 with
    code 0 mapping to 0, computed once.  The kernel and the plain wave
    both read this table."""
    global _cost_table
    if _cost_table is None:
        c = torch.arange(256, dtype=torch.float32)
        _cost_table = torch.where(
            c == 0, 0.0, _COST_XMIN * torch.exp(_COST_KLOG * (c - 1.0))
        )
    return _cost_table


# (field, dtype) of each format's six arrays, widest first so that every
# view of the one byte buffer is aligned
_WIRE_LAYOUT = {
    "f16": (("heavy", torch.int32), ("heavy2", torch.int32), ("dur", torch.float16),
            ("xp", torch.float16), ("xp2", torch.float16), ("xa", torch.float16)),
    "packed": (("heavy", torch.int32), ("dur", torch.float16), ("heavy2", torch.int16),
               ("xp", torch.uint8), ("xp2", torch.uint8), ("xa", torch.uint8)),
}
_NP_DTYPE = {torch.int32: np.int32, torch.int16: np.int16,
             torch.float16: np.float16, torch.uint8: np.uint8}
WIRE_BYTES = {fmt: sum(torch.empty((), dtype=d).element_size() for _, d in fields)
              for fmt, fields in _WIRE_LAYOUT.items()}  # f16: 16, packed: 11


def _wire_spans(T: int, fmt: str):
    """(field, dtype, first byte, bytes a row) of each array in the buffer."""
    lo, out = 0, []
    for name, dtype in _WIRE_LAYOUT[fmt]:
        size = torch.empty((), dtype=dtype).element_size()
        out.append((name, dtype, lo, size))
        lo += size * T
    return out


class _Wire(NamedTuple):
    """The six level-sorted task arrays, views of one byte buffer.  In the
    packed format ``heavy`` is the pair's low word, ``heavy2`` its u16
    high bits (stored as i16) and the costs are u8 codes."""

    fmt: str
    buf: torch.Tensor     # u8[WIRE_BYTES[fmt] * T]
    dur: torch.Tensor     # f16[T]
    heavy: torch.Tensor   # i32[T] sorted index of the heaviest dep (-1 none)
    heavy2: torch.Tensor  # i32[T] (packed: i16[T])
    xp: torch.Tensor      # f16[T] transfer cost if co-located with heavy (packed: u8)
    xp2: torch.Tensor     # f16[T] ... with heavy2
    xa: torch.Tensor      # f16[T] ... anywhere else


def _alloc_wire(T: int, fmt: str, device) -> _Wire:
    buf = torch.empty(WIRE_BYTES[fmt] * T, dtype=torch.uint8, device=device)
    views = {name: buf[lo: lo + size * T].view(dtype)
             for name, dtype, lo, size in _wire_spans(T, fmt)}
    return _Wire(fmt=fmt, buf=buf, **views)


def _encode_rows(packed: PackedGraph, fmt: str, i0: int, i1: int, out: dict) -> None:
    """Rows [i0, i1) of the packed graph, in the wire format, into the
    numpy arrays ``out`` (field -> array of T rows).  The casts and codes
    are the reference's: numpy's f16 rounding, ``_enc_heavy_pair``,
    ``_enc_cost``."""
    sl = slice(i0, i1)
    out["dur"][sl] = packed.duration_s[sl]
    costs = (("xp", packed.xfer_pref_s), ("xp2", packed.xfer_pref2_s),
             ("xa", packed.xfer_all_s))
    if fmt == "packed":
        lo, hi = _enc_heavy_pair(packed.heavy_s[sl], packed.heavy2_s[sl])
        out["heavy"][sl] = lo
        out["heavy2"][sl] = hi.view(np.int16)
        for name, arr in costs:
            out[name][sl] = _enc_cost(arr[sl])
    else:
        out["heavy"][sl] = packed.heavy_s[sl]
        out["heavy2"][sl] = packed.heavy2_s[sl]
        for name, arr in costs:
            out[name][sl] = arr[sl]


class PinnedPool:
    """Page-locked host buffers kept across calls: pinning 16 MB costs
    milliseconds.  :meth:`take` hands out a buffer that no copy still
    reads or writes (it waits on the event the buffer was given back
    with); :meth:`give` returns one with the event of its last copy.  The
    pool keeps the ``KEEP`` largest free buffers."""

    KEEP = 8

    def __init__(self):
        self._lock = threading.Lock()
        self._free: list[tuple[torch.Tensor, torch.cuda.Event | None]] = []
        self.allocated = 0  # buffers pinned so far

    def take(self, nbytes: int) -> torch.Tensor:
        """A pinned u8 buffer of at least ``nbytes``."""
        with self._lock:
            fits = [i for i, (b, _) in enumerate(self._free) if b.numel() >= nbytes]
            if fits:
                buf, event = self._free.pop(min(fits, key=lambda i: self._free[i][0].numel()))
            else:
                buf, event = None, None
                self.allocated += 1
        if buf is None:
            return torch.empty(_bucket(nbytes, floor=1 << 16), dtype=torch.uint8,
                               pin_memory=True)
        if event is not None:
            event.synchronize()
        return buf

    def give(self, buf: torch.Tensor, event: torch.cuda.Event | None) -> None:
        with self._lock:
            self._free.append((buf, event))
            if len(self._free) > self.KEEP:
                self._free.sort(key=lambda be: be[0].numel())
                self._free.pop(0)


PINNED = PinnedPool()


class _DeviceClock:
    """Summed device time of marked stretches of stream work, from CUDA
    events; inert unless enabled."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.pairs: list = []

    @contextlib.contextmanager
    def stretch(self):
        if not self.enabled:
            yield
            return
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        yield
        end.record()
        self.pairs.append((start, end))

    def ms(self) -> float | None:
        if not self.enabled:
            return None
        return sum(a.elapsed_time(b) for a, b in self.pairs)


class _Uploader:
    """Rows of the run's packed graph onto its wire, a chunk at a time.

    On CUDA the rows are encoded into a pinned staging buffer at their
    final byte offsets, copied with ``non_blocking=True`` on a side
    stream, and the compute stream (the current stream) waits on the
    chunk's event, so every later launch sees the rows.  Only copies run
    on the side stream.  On the CPU the rows are encoded into the wire
    itself; any other device gets a plain copy.
    """

    def __init__(self, run: "LeveledRun", timed: bool = False):
        self.run = run
        self.kind = run.device.type
        nbytes = run.wire.buf.numel()
        self.event = None
        self.clock = _DeviceClock(timed and self.kind == "cuda")
        if self.kind == "cpu":
            self.host = run.wire.buf
        elif self.kind == "cuda":
            self.pinned = PINNED.take(nbytes)
            self.host = self.pinned[:nbytes]
            self.stream = torch.cuda.Stream(run.device)
            # the wire's memory may have served work still queued on the
            # compute stream: copy into it only after that work
            self.stream.wait_stream(torch.cuda.current_stream(run.device))
        else:
            self.host = torch.empty(nbytes, dtype=torch.uint8)
        T = run.packed.n
        self.spans = _wire_spans(T, run.wire.fmt)
        host_np = self.host.numpy()
        self.views = {name: host_np[lo: lo + size * T].view(_NP_DTYPE[dtype])
                      for name, dtype, lo, size in self.spans}

    def send(self, i0: int, i1: int) -> None:
        """Encode rows [i0, i1) and put them on the device."""
        if i1 <= i0:
            return
        _encode_rows(self.run.packed, self.run.wire.fmt, i0, i1, self.views)
        if self.kind == "cpu":
            return
        dev = self.run.wire.buf
        ranges = [(lo + size * i0, lo + size * i1) for _, _, lo, size in self.spans]
        if self.kind != "cuda":
            for a, b in ranges:
                dev[a:b].copy_(self.host[a:b])
            return
        with torch.cuda.stream(self.stream):
            with self.clock.stretch():
                for a, b in ranges:
                    dev[a:b].copy_(self.host[a:b], non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(self.stream)
        torch.cuda.current_stream(self.run.device).wait_event(self.event)

    def close(self) -> None:
        if self.kind == "cuda":
            PINNED.give(self.pinned, self.event)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _Downloader:
    """The run's (assign+1)*4+choice codes, a segment of sorted rows at a
    time.  On CUDA each segment is packed on the compute stream and
    copied to pinned host memory on a side stream, so the host waits
    only for the last segment.  Only copies run on the side stream."""

    def __init__(self, run: "LeveledRun"):
        self.run = run
        T = run.packed.n
        dtype = torch.int32 if run.wide else torch.int16
        self.cuda = run.device.type == "cuda"
        self.event = None
        self.wait_s = 0.0
        if self.cuda:
            nbytes = T * torch.empty((), dtype=dtype).element_size()
            self.pinned = PINNED.take(max(nbytes, 1))
            self.host = self.pinned[:nbytes].view(dtype)
            self.stream = torch.cuda.Stream(run.device)
        else:
            self.host = torch.empty(T, dtype=dtype)

    def segment(self, i0: int, i1: int) -> None:
        """Download the codes of rows [i0, i1), final after the launches
        queued so far."""
        if i1 <= i0:
            return
        codes = self.run.codes(i0, i1)
        if not self.cuda:
            self.host[i0:i1].copy_(codes)
            return
        self.stream.wait_stream(torch.cuda.current_stream(self.run.device))
        with torch.cuda.stream(self.stream):
            self.host[i0:i1].copy_(codes, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(self.stream)
        codes.record_stream(self.stream)

    def finish(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(i32 codes, spans, load) on the host, after the last segment."""
        t0 = time.perf_counter()
        if self.event is not None:
            self.event.synchronize()
        self.wait_s = time.perf_counter() - t0
        codes = self.host.numpy().astype(np.int32)
        if self.cuda:
            PINNED.give(self.pinned, self.event)
        return codes, self.run.spans.cpu().numpy(), self.run.load.cpu().numpy()


# ------------------------------------------------------------- device side


class _Fleet(NamedTuple):
    W: int
    inv_t: torch.Tensor    # f32[W] 1 / max(nthreads, 1)
    running: torch.Tensor  # bool[W]
    ovt0: torch.Tensor     # f32[W] occ0 / threads, +inf where not running
    w_run: int             # running workers with threads (>= 1)
    uniform: bool
    ovt_c: float           # uniform path: occ0[0] / threads[0], an f32 value
    inv_c: float           # uniform path: inv_t[0], an f32 value


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
    """One placement on one device: the graph's wire and fleet, and the
    state the waves carry (``assign``/``choices`` per sorted task,
    cumulative ``load`` per worker, ``spans`` per wave).

    The device buffers are allocated here, at their full size, before any
    row lands.  With ``upload=True`` (the one-shot driver) every row is
    then uploaded at once; the streamed driver passes ``upload=False``
    and sends rows through :meth:`uploader` as the pack fills them.
    """

    def __init__(self, packed: PackedGraph, nthreads, occupancy0, running,
                 device=None, fmt: str = "f16", upload: bool = True):
        if fmt not in _WIRE_LAYOUT:
            raise ValueError(f"wire format {fmt!r}: expected one of {sorted(_WIRE_LAYOUT)}")
        if fmt == "packed" and packed.n + 1 > _PACK_LIMIT:
            raise ValueError(f"the packed wire holds at most {_PACK_LIMIT - 1} tasks")
        self.device = resolve_device(device)
        self.packed = packed
        self.wide, uniform, thr_h, run_h, occ_h = _worker_params(
            nthreads, occupancy0, running
        )
        T, L = packed.n, packed.n_levels
        self.wire = _alloc_wire(T, fmt, self.device)
        self.cost_table = cost_table().to(self.device) if fmt == "packed" else None
        self.fleet = _make_fleet(thr_h, run_h, occ_h, uniform, self.device)
        self.occ0 = torch.from_numpy(occ_h).to(self.device)
        W = self.fleet.W
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
        if upload:
            with self.uploader() as up:
                up.send(0, T)

    def uploader(self, timed: bool = False) -> _Uploader:
        """A context that sends rows of the packed graph to the wire
        (``send(i0, i1)``); ``timed`` sums the copies' device time."""
        return _Uploader(self, timed)

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

    def codes(self, i0: int = 0, i1: int | None = None) -> torch.Tensor:
        """``(assign+1)*4 + choice`` of sorted rows [i0, i1) (all by
        default), int16 unless the fleet is too wide for it: what the
        host downloads."""
        sl = slice(i0, self.packed.n if i1 is None else i1)
        out = (self.assign[sl] + 1) * 4 + self.choices[sl].clamp(0, 2)
        return out if self.wide else out.to(torch.int16)

    def download(self) -> LeveledResult:
        """Every row's codes in one segment, unpacked in task order."""
        down = _Downloader(self)
        down.segment(0, self.packed.n)
        return _finalize(self.packed, *down.finish())


def _argmin3(c0, c1, c2):
    """Elementwise argmin over three cost rows, first minimum on ties."""
    m01 = torch.where(c0 <= c1, 0, 1)
    v01 = torch.minimum(c0, c1)
    return torch.where(v01 <= c2, m01, 2)


def _sel3(ch, a0, a1, a2):
    return torch.where(ch == 0, a0, torch.where(ch == 1, a1, a2))


def _wire_rows(run: LeveledRun, sl: slice):
    """Rows ``sl`` of the wire as the waves compute with them: f32
    duration and costs, i64 heavy indices (the packed wire's decode, the
    reference's ``fmt == "packed"`` branch, with the costs read from
    :func:`cost_table`)."""
    wire = run.wire
    dur = wire.dur[sl].float()
    if wire.fmt == "packed":
        v = wire.heavy[sl]
        hi = wire.heavy2[sl].to(torch.int32) & 0xFFFF
        heavy = ((v & 0x1FFFFF) - 1).long()
        # an arithmetic shift, masked to the 11 bits a logical one leaves
        heavy2 = ((((v >> 21) & 0x7FF) | (hi << 11)) - 1).long()
        table = run.cost_table
        xp, xp2, xa = (table[c.long()] for c in (wire.xp[sl], wire.xp2[sl], wire.xa[sl]))
    else:
        heavy = wire.heavy[sl].long()
        heavy2 = wire.heavy2[sl].long()
        xp, xp2, xa = (c[sl].float() for c in (wire.xp, wire.xp2, wire.xa))
    return dur, heavy, heavy2, xp, xp2, xa


def place_wave_reference(run: LeveledRun, wave: int) -> None:
    """One wave in torch ops: the plain version of the wave kernel.

    The reference's ``run_wave`` body expression for expression, each
    of its two fleet branches with its own evaluation order, so on the
    CPU it reproduces the reference bit for bit.
    """
    fleet = run.fleet
    W = fleet.W
    offset, f = run.wave_bounds(wave)
    sl = slice(offset, offset + f)
    inf = float("inf")
    dur, heavy, heavy2, xp, xp2, xa = _wire_rows(run, sl)

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
    hand-written kernel ``csrc/place_wave.cu``, on the run's wire in
    either format.

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
    wire_args = [(name, getattr(wire, name), dtype, T) for name, dtype in _WIRE_LAYOUT[wire.fmt]]
    if wire.fmt == "packed":
        wire_args.append(("cost_table", run.cost_table, torch.float32, 256))
    for name, t, dtype, n in (
        *wire_args,
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
    rc = _build.launch(run.device, lib.dtpu_place_waves,
        P(wire.dur), P(wire.heavy), P(wire.heavy2), P(wire.xp), P(wire.xp2), P(wire.xa),
        None if run.cost_table is None else P(run.cost_table),
        P(run.assign), P(run.choices), P(run.load), P(run.spans),
        P(fleet.inv_t), P(fleet.running), P(fleet.ovt0), P(run.wave_offsets),
        P(sc.tl), P(sc.wave_load), P(sc.tgt), P(sc.wt), P(sc.sorted),
        P(sc.cnt), P(sc.start), P(sc.tot),
        None if stamps is None else P(stamps),
        W, first, last, fleet.w_run, int(fleet.uniform), sc.blocks,
        fleet.ovt_c, fleet.inv_c,
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


def place_graph_streamed(
    durations,
    out_bytes,
    src,
    dst,
    nthreads,
    occupancy0,
    running,
    bandwidth: float = 100e6,
    latency: float = 0.001,
    compact: bool | str = "auto",
    chunk_rows: int = 131072,
    min_stream: int = 262144,
    timings: dict | None = None,
    device=None,
    mesh=None,
    fleet_dev=None,
    stats: dict | None = None,
) -> tuple[PackedGraph, LeveledResult]:
    """Fused pack + place: the upload overlaps the pack's row fill, and
    the waves run as their rows land.  The reference's
    ``place_graph_streamed``; with ``mesh`` (an engine mesh from
    ``ops/partition.make_engine_mesh``) its mesh branch, which
    :func:`distributed_tpu_torch.ops.sharded.place_graph_streamed_sharded`
    runs on the mesh's devices (``device`` is then not used; ``fleet_dev``
    and ``stats`` pass through to the sharded engine).

    - The topology phase (``graphpack_topo``: edge passes, Kahn peel,
      counting sort) runs on the calling thread; sorted order does not
      exist before it.
    - The row fill (``graphpack_fill``) runs on a worker thread in
      ``chunk_rows`` chunks (the C call releases the GIL).
    - The calling thread encodes each finished chunk into pinned memory
      and copies it on a side stream, then makes one launch of every
      wave whose last row has landed (on the CPU, the plain wave for
      each).  Waves run at their true size, so none reads past the
      landed rows.
    - Rows final after a launch are downloaded in segments of at least
      ``max(T // 4, 4096)`` rows behind the remaining work, and the C
      ``unpack_assignment`` puts the codes in task order.

    ``compact="auto"`` picks the 11 B/task packed wire off the CPU and
    the f16 wire on it, as the reference does; the packed wire is used
    only while the reference's padded size stays under ``_PACK_LIMIT``.
    It quantizes the transfer costs (+-4.5 %); ``compact=False`` is
    bit-identical to :func:`place_graph_leveled`.

    Below ``min_stream`` tasks this is :func:`pack_graph` then
    :func:`place_graph_leveled`, as in the reference.

    ``timings`` receives the reference's keys: ``topo_s`` (the serial
    pack phase), ``fmt``, ``fallback`` (only below ``min_stream``) and
    ``total_s``; the streamed path adds ``fill_wait_s`` (waiting on the
    filler), ``encode_s`` (encoding and issuing the chunk copies),
    ``launches``, ``wait_s`` (the final segment), ``finalize_s`` (the C
    unpack) and, on CUDA, ``upload_ms`` and ``waves_ms``: the device
    time of the chunk copies and of the launches (CUDA events).

    Returns ``(packed, result)``; ``packed``'s host arrays are fully
    filled by return time.
    """
    if mesh is not None:
        from distributed_tpu_torch.ops import sharded

        return sharded.place_graph_streamed_sharded(
            durations, out_bytes, src, dst, nthreads, occupancy0, running, mesh,
            bandwidth=bandwidth, latency=latency, chunk_rows=chunk_rows,
            min_stream=min_stream, timings=timings, fleet_dev=fleet_dev, stats=stats,
        )
    dev = resolve_device(device)
    durations, out_bytes, src, dst = _graph_arrays(durations, out_bytes, src, dst)
    T = len(durations)
    E = len(src)
    if T == 0 or T < min_stream:
        t0 = time.perf_counter()
        packed = pack_graph(durations, out_bytes, src, dst,
                            bandwidth=bandwidth, latency=latency)
        if timings is not None:
            timings["topo_s"] = time.perf_counter() - t0
            timings["fmt"] = "f16"
            timings["fallback"] = True
        result = place_graph_leveled(packed, nthreads, occupancy0, running, device=dev)
        if timings is not None:
            timings["total_s"] = time.perf_counter() - t0
        return packed, result
    if len(out_bytes) != T or len(dst) != E:
        raise ValueError("durations/out_bytes and src/dst must have equal lengths")

    t0 = time.perf_counter()
    topo = _StreamPack(durations, out_bytes, src, dst, bandwidth, latency)
    offsets, n_levels = topo.offsets, topo.n_levels
    packed = topo.alloc(T)
    if timings is not None:
        timings["topo_s"] = time.perf_counter() - t0

    if compact == "auto":
        # the packed wire exists to shrink the host-to-device copy; on
        # the CPU "upload" is a memcpy and the encode is pure extra work
        compact = dev.type != "cpu"
    Tp = T + _compute_pad(T, _plan_runs(offsets), offsets)
    fmt = "packed" if (compact and Tp < _PACK_LIMIT) else "f16"
    if timings is not None:
        timings["fmt"] = fmt
    run = LeveledRun(packed, nthreads, occupancy0, running, device=dev, fmt=fmt,
                     upload=False)

    timed = timings is not None and dev.type == "cuda"
    waves_clock = _DeviceClock(timed)
    encode_s = 0.0
    launches = 0
    wave, seg_from, seg_min = 0, 0, max(T // 4, 4096)
    try:
        with run.uploader(timed) as up:
            down = _Downloader(run)
            for i0, i1 in topo.fill(chunk_rows):
                t2 = time.perf_counter()
                up.send(i0, i1)
                encode_s += time.perf_counter() - t2
                last = wave
                while last < n_levels and offsets[last + 1] <= i1:
                    last += 1
                if last == wave:
                    continue
                with waves_clock.stretch():
                    place_waves(run, wave, last)
                launches += 1
                wave = last
                rows_done = int(offsets[wave])
                if rows_done - seg_from >= seg_min or wave == n_levels:
                    down.segment(seg_from, rows_done)
                    seg_from = rows_done
    finally:
        topo.join()
    if wave != n_levels:
        raise RuntimeError(f"placed {wave} of {n_levels} waves")
    codes, spans_h, load_h = down.finish()
    t3 = time.perf_counter()
    result = _finalize(packed, codes, spans_h, load_h)
    if timings is not None:
        timings.update(
            fill_wait_s=topo.fill_wait_s, encode_s=encode_s, launches=launches,
            wait_s=down.wait_s, finalize_s=time.perf_counter() - t3,
        )
        if timed:
            timings.update(upload_ms=up.clock.ms(), waves_ms=waves_clock.ms())
        timings["total_s"] = time.perf_counter() - t0
    return packed, result



class _StreamPack:
    """The streamed driver's pack: the topology pass (``graphpack_topo``)
    on the calling thread at construction, then the row fill
    (``graphpack_fill``) on a worker thread, a chunk at a time (the C call
    releases the GIL).  Raises ``ValueError`` on a cycle."""

    def __init__(self, durations, out_bytes, src, dst, bandwidth: float, latency: float):
        T, E = len(durations), len(src)
        self.lib = native.load()
        P = native.as_ptr
        self.level, self.perm, self.heavy, self.heavy2, self.indeg, self.inv = (
            np.empty(T, np.int32) for _ in range(6))
        offsets_buf = np.empty(T + 1, np.int32)  # the pass writes [0, n_levels]
        self.dep_total = np.empty(T, np.float32)
        n_levels = self.lib.graphpack_topo(
            T, E, P(out_bytes), P(src), P(dst),
            P(self.level), P(self.perm), P(offsets_buf),
            P(self.heavy), P(self.heavy2), P(self.dep_total), P(self.indeg), P(self.inv),
        )
        if n_levels < 0:
            raise ValueError("graph has a cycle")
        self.T = T
        self.n_levels = int(n_levels)
        self.offsets = offsets_buf[: n_levels + 1].copy()
        self.inputs = (durations, out_bytes, 1.0 / bandwidth, float(latency))
        self.fill_wait_s = 0.0
        self._thread: threading.Thread | None = None

    def alloc(self, size: int, zero: bool = False) -> PackedGraph:
        """The fill's target arrays, ``size >= T`` rows (zeroed with
        ``zero``; past T they are never written), as a :class:`PackedGraph`
        of their first T rows.  ``self.bufs`` keeps the full arrays."""
        new = np.zeros if zero else np.empty
        self.bufs = (new(size, np.float32), new(size, np.int32), new(size, np.int32),
                     new(size, np.float32), new(size, np.float32), new(size, np.float32))
        dur_s, heavy_s, heavy2_s, xp_s, xp2_s, xa_s = (b[: self.T] for b in self.bufs)
        return PackedGraph(
            perm=self.perm, level=self.level, offsets=self.offsets, n_levels=self.n_levels,
            duration_s=dur_s, heavy_s=heavy_s, heavy2_s=heavy2_s,
            xfer_pref_s=xp_s, xfer_pref2_s=xp2_s, xfer_all_s=xa_s,
        )

    def fill(self, chunk_rows: int):
        """Start the fill and yield each chunk's ``(i0, i1)`` once its rows
        are filled; raises on the calling thread if the fill failed."""
        T = self.T
        C = max(min(chunk_rows, T), 1)
        bounds = [(i0, min(i0 + C, T)) for i0 in range(0, T, C)]
        done = [threading.Event() for _ in bounds]
        fill_err: list[Exception] = []
        P = native.as_ptr
        durations, out_bytes, inv_bw, latency = self.inputs
        fill_args = (
            P(durations), P(out_bytes), P(self.perm), P(self.inv), P(self.heavy),
            P(self.heavy2), P(self.dep_total), P(self.indeg), inv_bw, latency,
            *(P(b) for b in self.bufs),
        )

        def filler():
            try:
                for (i0, i1), evt in zip(bounds, done):
                    self.lib.graphpack_fill(i0, i1, *fill_args)
                    evt.set()
            except Exception as exc:  # reported to the calling thread, which raises
                fill_err.append(exc)
                for evt in done:
                    evt.set()

        self._thread = threading.Thread(target=filler, name="graphpack-fill", daemon=True)
        self._thread.start()
        for (i0, i1), evt in zip(bounds, done):
            t1 = time.perf_counter()
            evt.wait()
            self.fill_wait_s += time.perf_counter() - t1
            if fill_err:
                raise RuntimeError("graph pack fill failed") from fill_err[0]
            yield i0, i1

    def join(self) -> None:
        if self._thread is not None:
            self._thread.join()


def _finalize(packed: PackedGraph, codes: np.ndarray, spans_h: np.ndarray,
              load_h: np.ndarray) -> LeveledResult:
    """The downloaded codes into original task order, in one C sweep
    (``unpack_assignment``), and the wave start times."""
    T, L = packed.n, packed.n_levels
    assignment = np.full(T, -1, np.int32)
    choice = np.full(T, 2, np.int8)
    if T:
        codes = np.ascontiguousarray(codes, np.int32)
        perm = np.ascontiguousarray(packed.perm, np.int32)
        if codes.shape != (T,):
            raise ValueError(f"expected {T} codes, got {codes.shape}")
        native.load().unpack_assignment(
            T, native.as_ptr(codes), native.as_ptr(perm),
            native.as_ptr(assignment), native.as_ptr(choice),
        )
    wave_start = np.concatenate([[0.0], np.cumsum(spans_h)[:-1]]).astype(np.float32)
    start_time = wave_start[np.maximum(packed.level, 0)] if L else np.zeros(T, np.float32)
    return LeveledResult(
        assignment=assignment,
        start_time=start_time,
        occupancy=load_h,
        n_waves=L,
        level=packed.level,
        choice=choice,
        spans=spans_h,
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
