"""The sharded leveled engine, PyTorch + CUDA port (kernel K10).

The counterpart of ``distributed_tpu/ops/leveled.py``'s sharded engine
(``leveled.py:1085-1505``): the same level-synchronous placement as
:mod:`distributed_tpu_torch.ops.leveled`, partitioned over an engine mesh
(:func:`~distributed_tpu_torch.ops.partition.make_engine_mesh`, 2-D
``(tasks, workers)``).  Every wave's window of ``F = D * Fl`` sorted rows
is split contiguously over the flattened shard order (shard ``d`` owns
rows ``[d*Fl, (d+1)*Fl)``, each row's rank is ``d*Fl + j``, ranks at or
past the wave's size are padding), the fleet rows shard over ``workers``
when the mirror feeds them, and a wave combines its shards with exactly
two collectives: a ``psum`` of the per-worker wave load (twice: the
tentative load, then the final one) and an ``all_gather`` of the
assignment slice, so the next wave's locality lookups see every shard.

The reference runs that body as one ``shard_map`` program.  Here the
shard body is written once against a small comm interface with two
implementations, and the collectives are explicit calls in a fixed order:

- :class:`LocalShards`: all D shards in one process, each on a device of
  the mesh's list (which may repeat one card, or the CPU).  ``psum`` adds
  the shards' ``[W]`` partials in shard order, ``acc = p[0]; acc = acc +
  p[1]; ...``, which is also the order XLA's CPU backend adds them, so on
  the CPU the port equals the reference bit for bit on every layout;
  ``all_gather`` concatenates the slices in shard order.
- :class:`ProcessGroupShards`: one shard per rank of a
  ``torch.distributed`` group (``all_reduce`` of the partials,
  ``all_gather_into_tensor`` of the slices).

The shard body has two implementations with one contract:
:func:`shard_tentative_reference` / :func:`shard_contend_reference`, the
reference's ``local`` body in torch ops (the CPU path, and the plain
version the kernel is held against), and the hand-written kernel
``csrc/place_shard.cu`` (K10) for all the shards a process holds on one
device, each shard's partials summed in task order as the plain version
on the CPU sums them.  K10 runs in one of two modes, which
:func:`shard_mode` picks from the comm, the shards' devices and the body:

- run mode (:func:`place_shard_run_cuda`), when every shard lives in this
  process on one CUDA device (``LocalShards``, the default body): one
  cooperative launch a fused run, every wave of it, with the psums in
  shard order, the load, the span and the slice writes inside the launch,
  as the reference runs a fused run as one program;
- step mode (:func:`place_shard_cuda`), for ``ProcessGroupShards``, a
  ``LocalShards`` mesh over several devices, or the explicit pair
  ``(shard_tentative, shard_contend)``: two launches a wave, the
  collectives issued by the host between them.

The device of each shard comes from the mesh: a CUDA mesh runs the
kernel, a CPU mesh the plain version.  No path moves from one to the
other, or from run mode to step mode, when the kernel cannot be built or
launched: it raises.
"""

from __future__ import annotations

import ctypes
import functools
import time
from typing import NamedTuple

import numpy as np
import torch

from distributed_tpu_torch.ops import _build
from distributed_tpu_torch.ops.comm import LocalShards, ProcessGroupShards  # noqa: F401
from distributed_tpu_torch.ops.leveled import (
    MAX_WORKERS_CUDA,
    SMALL_WAVE,
    LeveledResult,
    PackedGraph,
    _argmin3,
    _bucket,
    _compute_pad,
    _Downloader,
    _finalize,
    _Fleet,
    _graph_arrays,
    _plan_runs,
    _sel3,
    _StreamPack,
    _worker_params,
    pack_graph,
)
from distributed_tpu_torch.ops.partition import EngineMesh, shard_bucket

# the sharded wire is always the f16 format: (field, numpy dtype) of the
# six task arrays in the order the tiles are shipped
TASK_FIELDS = (("dur", np.float16), ("heavy", np.int32), ("heavy2", np.int32),
               ("xp", np.float16), ("xp2", np.float16), ("xa", np.float16))
TILE_BYTES = sum(np.dtype(d).itemsize for _, d in TASK_FIELDS)  # 16 a row
_TORCH_DTYPE = {np.float16: torch.float16, np.int32: torch.int32}

def _plan_runs_sharded(offsets: np.ndarray, n_shards: int):
    """Fused runs ``[(Fl, [wave, ...])]`` where ``Fl`` is the per-shard
    power-of-two bucket of the wave size; the reference's grouping with
    its own floor of 512 (not :func:`shard_bucket`'s default 2048) and a
    small bucket of ``max(SMALL_WAVE // n_shards, 2048)``."""
    return _plan_runs(
        offsets,
        bucket_fn=lambda f: shard_bucket(f, n_shards, floor=512),
        small=max(SMALL_WAVE // max(n_shards, 1), 2048),
    )


# ----------------------------------------------------------- collectives

# LocalShards and ProcessGroupShards live in ops/comm.py (imported above)


# ------------------------------------------------------------ shard state


class _Replica(NamedTuple):
    """The replicated carry on one device: every shard there reads it."""

    assign: torch.Tensor   # i32[Tp] worker per sorted row (-1 not placed)
    choices: torch.Tensor  # i32[Tp]
    load: torch.Tensor     # f32[W] cumulative modeled load
    spans: torch.Tensor    # f32[Lp] per-wave span
    fleet: _Fleet


class _Group:
    """The shards this process holds on one device, in shard order: their
    tiles of the current fused run, the kernel's scratch, and their
    outputs of the current wave."""

    def __init__(self, device: torch.device, shards: list[int], W: int):
        self.device = device
        self.shards = shards
        self.shard_ids = torch.tensor(shards, dtype=torch.int32, device=device)
        self.W = W
        self.Fl = 0
        self.tiles: dict[str, torch.Tensor] = {}
        self.bx = 0
        self.stash = None  # the plain version's launch-A values, for launch B

    def shape_for(self, Fl: int) -> None:
        """Scratch and outputs for per-shard slices of ``Fl`` rows."""
        if Fl == self.Fl:
            return
        S, W, dev = len(self.shards), self.W, self.device
        i32, f32 = torch.int32, torch.float32
        self.Fl = Fl
        self.tgt = torch.empty(S, Fl, dtype=i32, device=dev)
        self.wt = torch.empty(S, Fl, dtype=f32, device=dev)
        self.spread = torch.empty(S, Fl, dtype=i32, device=dev)
        self.sorted = torch.empty(S, Fl, dtype=f32, device=dev)
        self.aslice = torch.empty(S, Fl, dtype=i32, device=dev)
        self.cslice = torch.empty(S, Fl, dtype=i32, device=dev)
        self.tl_part = torch.empty(S, W, dtype=f32, device=dev)
        self.wl_part = torch.empty(S, W, dtype=f32, device=dev)
        self.start = torch.empty(S, W, dtype=i32, device=dev)
        self.tot = torch.empty(S, W, dtype=i32, device=dev)
        self.tl = torch.empty(W, dtype=f32, device=dev)  # run mode's tentative psum


def _fleet_from_tensors(nthreads: torch.Tensor, running: torch.Tensor,
                        occ0: torch.Tensor, uniform: bool) -> _Fleet:
    """The wave body's fleet tables from full ``[W]`` tensors, computed on
    their device as the reference's ``local`` computes them after its
    fleet gather (``ovt_c`` and ``inv_c`` read global row 0)."""
    inv_t = 1.0 / nthreads.clamp_min(1).to(torch.float32)
    ovt0 = torch.where(running, occ0 * inv_t, float("inf"))
    return _Fleet(
        W=int(nthreads.numel()), inv_t=inv_t, running=running, ovt0=ovt0,
        w_run=max(int((running & (nthreads > 0)).sum()), 1), uniform=uniform,
        ovt_c=float((occ0[0] * inv_t[0]).item()), inv_c=float(inv_t[0].item()),
    )


# ------------------------------------------------------------ shard body


def _shard_rows(g: _Group, rep: _Replica, k: int, f: int):
    """A wave's rows on the group's shards, ``[S, Fl]`` each: f32 duration
    and costs, i64 heavy indices, the global rank and the validity."""
    t = g.tiles
    dur = t["dur"][:, k].float()
    heavy = t["heavy"][:, k].long()
    heavy2 = t["heavy2"][:, k].long()
    xp, xp2, xa = (t[n][:, k].float() for n in ("xp", "xp2", "xa"))
    rank = g.shard_ids.long()[:, None] * g.Fl + torch.arange(g.Fl, device=g.device)
    valid = rank < f
    pref = torch.where((heavy >= 0) & valid, rep.assign[heavy.clamp_min(0)], -1)
    p = pref.clamp_min(0).long()
    ok1 = pref >= 0
    pref2 = torch.where((heavy2 >= 0) & valid, rep.assign[heavy2.clamp_min(0)], -1)
    p2 = pref2.clamp_min(0).long()
    ok2 = (pref2 >= 0) & (pref2 != pref)
    return dur, xp, xp2, xa, rank, valid, p, p2, ok1, ok2


def _per_shard_sum(g: _Group, target: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``[S, W]``: each shard's values summed per worker in row order (one
    ``index_add_`` over the flattened rows, every target in its own
    shard's range, so each sum runs in its shard's row order)."""
    S, W = len(g.shards), g.W
    base = torch.arange(S, device=g.device)[:, None] * W
    out = torch.zeros(S * W, dtype=torch.float32, device=g.device)
    return out.index_add_(0, (base + target).view(-1), values.reshape(-1)).view(S, W)


def shard_tentative_reference(g: _Group, rep: _Replica, k: int, f: int) -> None:
    """Launch A in torch ops: the candidates, the first argmin and each
    shard's tentative load partial into ``g.tl_part``; the reference's
    ``local`` body up to its first ``psum``, expression for expression."""
    fl = rep.fleet
    W, inf = fl.W, float("inf")
    dur, xp, xp2, xa, rank, valid, p, p2, ok1, ok2 = _shard_rows(g, rep, k, f)
    order = torch.argsort(torch.where(fl.running, rep.load * fl.inv_t, inf), stable=True)
    block = max((f + fl.w_run - 1) // fl.w_run, 1)
    spread = order[(rank // block).clamp(0, W - 1)]
    f32 = dict(dtype=torch.float32, device=g.device)
    if fl.uniform:
        ovt_c = torch.tensor(fl.ovt_c, **f32)
        c0 = torch.where(ok1, xp + ovt_c, inf)
        c1 = torch.where(ok2, xp2 + ovt_c, inf)
        c2 = xa + ovt_c
    else:
        c0 = torch.where(ok1, fl.ovt0[p] + xp, inf)
        c1 = torch.where(ok2, fl.ovt0[p2] + xp2, inf)
        c2 = fl.ovt0[spread] + xa
    choice = _argmin3(c0, c1, c2)
    tent = _sel3(choice, p, p2, spread)
    xfer_t = _sel3(choice, xp, xp2, xa)
    tw = torch.where(valid, dur + xfer_t, 0.0)
    g.tl_part.copy_(_per_shard_sum(g, tent, tw))
    g.stash = (dur, xp, xp2, xa, valid, p, p2, ok1, ok2, spread, tent, tw)


def shard_contend_reference(g: _Group, rep: _Replica, k: int, f: int, tl: torch.Tensor) -> None:
    """Launch B in torch ops: the contention round against the summed
    tentative load ``tl``, the final choice into ``g.aslice`` /
    ``g.cslice`` and each shard's wave-load partial into ``g.wl_part``."""
    fl = rep.fleet
    inf = float("inf")
    dur, xp, xp2, xa, valid, p, p2, ok1, ok2, spread, tent, tw = g.stash
    g.stash = None
    if fl.uniform:
        f32 = dict(dtype=torch.float32, device=g.device)
        ovt_c = torch.tensor(fl.ovt_c, **f32)
        inv_c = torch.tensor(fl.inv_c, **f32)
        tli = tl * inv_c
        corr = tw * inv_c
        d0 = torch.where(ok1, tli[p] - torch.where(p == tent, corr, 0.0) + xp + ovt_c, inf)
        d1 = torch.where(ok2, tli[p2] - torch.where(p2 == tent, corr, 0.0) + xp2 + ovt_c, inf)
        d2 = tli[spread] - torch.where(spread == tent, corr, 0.0) + xa + ovt_c
    else:
        s_tab = fl.ovt0 + tl * fl.inv_t
        corr = tw * fl.inv_t[tent]
        d0 = torch.where(ok1, s_tab[p] - torch.where(p == tent, corr, 0.0) + xp, inf)
        d1 = torch.where(ok2, s_tab[p2] - torch.where(p2 == tent, corr, 0.0) + xp2, inf)
        d2 = s_tab[spread] - torch.where(spread == tent, corr, 0.0) + xa
    choice = _argmin3(d0, d1, d2)
    assign_w = torch.where(valid, _sel3(choice, p, p2, spread), -1)
    xfer = _sel3(choice, xp, xp2, xa)
    work = torch.where(assign_w >= 0, dur + xfer, 0.0)
    g.wl_part.copy_(_per_shard_sum(g, assign_w.clamp_min(0), work))
    g.aslice.copy_(assign_w)
    g.cslice.copy_(choice)


def _check_tensors(name: str, device: torch.device, entries) -> None:
    """Each ``(label, tensor, dtype, numel)`` a contiguous tensor on ``device``."""
    for label, t, dtype, n in entries:
        if t.dtype != dtype or t.numel() != n or not t.is_contiguous() or t.device != device:
            raise ValueError(f"{name}: {label} must be a contiguous {dtype}[{n}] on {device}")


def _kernel_setup(g: _Group, rep: _Replica, name: str) -> tuple[ctypes.CDLL, int]:
    """The kernel library and the run's wave slots K, after the group's
    grid and count scratch (the first time) and the checks every launch of
    either mode makes."""
    if g.device.type != "cuda":
        raise RuntimeError(f"{name} needs CUDA tensors, got {g.device}")
    fl = rep.fleet
    W, S, Fl = fl.W, len(g.shards), g.Fl
    if W > MAX_WORKERS_CUDA:
        raise ValueError(f"the shard kernel takes at most {MAX_WORKERS_CUDA} workers, got {W}")
    lib = _build.load()
    if g.bx == 0:
        bx = ctypes.c_int(0)
        _build.check(lib.dtpu_place_shard_grid(W, S, ctypes.byref(bx)), "dtpu_place_shard_grid")
        g.bx = bx.value
        g.cnt = torch.empty(S * W * g.bx, dtype=torch.int32, device=g.device)
    K = int(g.tiles["dur"].shape[1])
    _check_tensors(name, g.device, (
        *((n, g.tiles[n], _TORCH_DTYPE[d], S * K * Fl) for n, d in TASK_FIELDS),
        ("shard_ids", g.shard_ids, torch.int32, S),
        ("assign", rep.assign, torch.int32, rep.assign.numel()),
        ("load", rep.load, torch.float32, W), ("inv_t", fl.inv_t, torch.float32, W),
        ("running", fl.running, torch.bool, W), ("ovt0", fl.ovt0, torch.float32, W),
    ))
    return lib, K


def place_shard_cuda(g: _Group, rep: _Replica, k: int, f: int, tl: torch.Tensor | None = None) -> None:
    """One step-mode launch of the hand-written kernel
    ``csrc/place_shard.cu`` for the group's shards: launch A without
    ``tl`` (into ``g.tl_part``), launch B with it (into ``g.aslice``,
    ``g.cslice``, ``g.wl_part``)."""
    fl = rep.fleet
    W, S, Fl = fl.W, len(g.shards), g.Fl
    lib, K = _kernel_setup(g, rep, "place_shard_cuda")
    if tl is not None:
        _check_tensors("place_shard_cuda", g.device, (("tl", tl, torch.float32, W),))
    if not 0 <= k < K:
        raise ValueError(f"place_shard_cuda: wave slot {k} outside [0, {K})")
    P = _build.ptr
    rc = _build.launch(g.device, lib.dtpu_place_shard,
        *(P(g.tiles[n]) for n, _ in TASK_FIELDS), P(g.shard_ids), P(rep.assign),
        P(rep.load), P(fl.inv_t), P(fl.running), P(fl.ovt0), None if tl is None else P(tl),
        P(g.tgt), P(g.wt), P(g.spread), P(g.sorted), P(g.cnt), P(g.start), P(g.tot),
        P(g.wl_part if tl is not None else g.tl_part), P(g.aslice), P(g.cslice),
        W, S, K, Fl, k, f, fl.w_run, int(fl.uniform), int(tl is not None), g.bx,
        fl.ovt_c, fl.inv_c,
    )
    _build.check(rc, "dtpu_place_shard")
    place_shard_cuda.launches += 1


place_shard_cuda.launches = 0  # step-mode launches in this process


def place_shard_run_cuda(g: _Group, rep: _Replica) -> None:
    """One run-mode launch of ``csrc/place_shard.cu``: every wave of the
    fused run whose tiles and wave table (``g.tiles["waves"]``, from
    :func:`wave_table`) the group holds, for a group that holds every
    shard of the mesh in shard order.  Updates the replica's assignment,
    choices, load and spans in place."""
    fl = rep.fleet
    W, S, Fl = fl.W, len(g.shards), g.Fl
    lib, K = _kernel_setup(g, rep, "place_shard_run_cuda")
    if g.shards != list(range(S)):
        raise ValueError(f"place_shard_run_cuda: the group holds shards {g.shards}, not all in order")
    _check_tensors("place_shard_run_cuda", g.device, (
        ("waves", g.tiles["waves"], torch.int32, 3 * K),
        ("choices", rep.choices, torch.int32, rep.assign.numel()),
        ("spans", rep.spans, torch.float32, rep.spans.numel()),
    ))
    P = _build.ptr
    rc = _build.launch(g.device, lib.dtpu_place_shard_run,
        *(P(g.tiles[n]) for n, _ in TASK_FIELDS), P(g.shard_ids), P(g.tiles["waves"]),
        P(rep.assign), P(rep.choices), P(rep.load), P(rep.spans), P(fl.inv_t), P(fl.running),
        P(fl.ovt0), P(g.tl), P(g.tgt), P(g.wt), P(g.spread), P(g.sorted), P(g.cnt), P(g.start),
        P(g.tot), W, S, K, Fl, fl.w_run, int(fl.uniform), g.bx, fl.ovt_c, fl.inv_c,
    )
    _build.check(rc, "dtpu_place_shard_run")
    place_shard_run_cuda.launches += 1


place_shard_run_cuda.launches = 0  # run-mode launches (one a fused run) in this process


def place_shard_run_reference(g: _Group, rep: _Replica) -> None:
    """What one run-mode launch computes, in torch ops: for each wave slot
    of the table (a padding wave, ``fs = 0``, skipped), the plain pair on
    the group's shards with the psums in shard order between, then the
    load, the span and the slices written at the wave's offset."""
    F = g.Fl * len(g.shards)
    for k, (offset, f, wi) in enumerate(zip(*g.tiles["waves"].tolist())):
        if f == 0:
            continue
        shard_tentative_reference(g, rep, k, f)
        tl = functools.reduce(torch.add, g.tl_part)  # in shard order, as LocalShards.psum
        shard_contend_reference(g, rep, k, f, tl)
        wl = functools.reduce(torch.add, g.wl_part)
        rep.load.add_(wl)
        rep.spans[wi] = torch.where(rep.fleet.running, wl * rep.fleet.inv_t, 0.0).max()
        rep.assign[offset: offset + F] = g.aslice.view(-1)
        rep.choices[offset: offset + F] = g.cslice.view(-1)


def shard_tentative(g: _Group, rep: _Replica, k: int, f: int) -> None:
    """Launch A on the group's device: the plain version on the CPU, the
    kernel otherwise (which raises off CUDA)."""
    if g.device.type == "cpu":
        shard_tentative_reference(g, rep, k, f)
    else:
        place_shard_cuda(g, rep, k, f)


def shard_contend(g: _Group, rep: _Replica, k: int, f: int, tl: torch.Tensor) -> None:
    """Launch B on the group's device, as :func:`shard_tentative`."""
    if g.device.type == "cpu":
        shard_contend_reference(g, rep, k, f, tl)
    else:
        place_shard_cuda(g, rep, k, f, tl)


PLAIN_BODY = (shard_tentative_reference, shard_contend_reference)


def shard_mode(comm, devices, body=None) -> str:
    """Which wave loop a run takes: ``"run"`` (K10's run mode, one launch a
    fused run) when the body is the device rule (``None``), the comm is
    :class:`LocalShards` and every shard's device is one CUDA device;
    ``"plain"`` for the plain pair, or the device rule on CPU shards;
    otherwise ``"step"`` (two launches a wave and host collectives: a
    process group, several devices, or an explicit pair)."""
    if body is not None:
        return "plain" if tuple(body) == PLAIN_BODY else "step"
    devs = {torch.device(d) for d in devices}
    if all(d.type == "cpu" for d in devs):
        return "plain"
    if isinstance(comm, LocalShards) and len(devs) == 1 and next(iter(devs)).type == "cuda":
        return "run"
    return "step"


def wave_table(packed: PackedGraph, waves: list[int], K: int, Lp: int) -> np.ndarray:
    """i32 ``[3, K]``: each wave slot's offset, size and span slot, as the
    reference's ``_ShardedRunState`` passes ``offs``, ``fs`` and ``widxs`` to its fused
    run; padding slots are ``(T, 0, Lp - 1)``."""
    table = np.empty((3, K), np.int32)
    table[0], table[1], table[2] = packed.n, 0, Lp - 1
    for i, w in enumerate(waves):
        table[:, i] = packed.offsets[w], packed.offsets[w + 1] - packed.offsets[w], w
    return table


# ------------------------------------------------------------ the driver


class ShardedRun:
    """One sharded placement: the shards this process holds (by the comm's
    ``local`` list) grouped by device, a replicated carry on each of those
    devices, and the per-run tiles.  The reference's ``_ShardedRunState``:
    :meth:`dispatch` ships one fused run's ``[K, Fl]`` tiles to each shard
    and runs its waves, :meth:`finalize` downloads the codes in segments
    and unpacks them.

    ``fleet_dev`` (the mirror's :meth:`sharded_device_view`) gives the
    fleet as ``workers``-axis blocks, gathered on each device, so a fresh
    cycle ships no fleet rows; the host ``nthreads``/``occupancy0``/
    ``running`` still seed the load carry and the uniform/wide decisions
    and must equal the device rows.  ``body`` is ``(tentative, contend)``
    for the two-launch loop (the device rule ``(shard_tentative,
    shard_contend)``, or ``PLAIN_BODY`` to run the plain pair on the
    card); None (the default) lets :func:`shard_mode` pick the loop, run
    mode where it can.
    """

    def __init__(self, mesh: EngineMesh, packed: PackedGraph, Tp: int, Lp: int,
                 nthreads, occupancy0, running, *, comm=None, fleet_dev=None,
                 stats: dict | None = None, body=None):
        self.mesh = mesh
        self.comm = comm if comm is not None else LocalShards(mesh)
        if self.comm.mesh != mesh:
            raise ValueError("the comm was made for another mesh")
        self.packed = packed
        self.Tp, self.Lp = Tp, Lp
        self.D = mesh.size
        self.body = body
        self.wide, self.uniform, thr_h, run_h, occ_h = _worker_params(
            nthreads, occupancy0, running
        )
        W = len(occ_h)
        if W == 0:
            raise ValueError("placement needs at least one worker")
        self.occ_h = occ_h
        self.sizes = np.diff(packed.offsets)
        groups: dict[torch.device, list[int]] = {}
        for d in self.comm.local:
            groups.setdefault(mesh.devices[d], []).append(d)
        self.groups = [_Group(dev, shards, W) for dev, shards in groups.items()]
        self.mode = shard_mode(self.comm, list(groups), body)
        if fleet_dev is not None:
            full = [self.comm.gather_workers(list(fleet_dev[f]))
                    for f in ("nthreads", "running", "occupancy")]
            if full[0].numel() != W:
                raise ValueError(f"fleet_dev holds {full[0].numel()} rows, the host arrays {W}")
        else:
            full = [torch.from_numpy(a) for a in (thr_h, run_h, occ_h)]
        self.replicas: dict[torch.device, _Replica] = {}
        for g in self.groups:
            nthr, run_t, occ = (t.to(g.device) for t in full)
            fleet = _fleet_from_tensors(nthr, run_t.to(torch.bool), occ, self.uniform)
            self.replicas[g.device] = _Replica(
                assign=torch.full((Tp,), -1, dtype=torch.int32, device=g.device),
                choices=torch.full((Tp,), 2, dtype=torch.int32, device=g.device),
                load=torch.tensor(occ_h, device=g.device),  # a copy: the carry is written
                spans=torch.zeros(Lp, dtype=torch.float32, device=g.device),
                fleet=fleet,
            )
        main = self.replicas[self.groups[0].device]
        # what the segmented download reads (leveled._Downloader)
        self.device = self.groups[0].device
        self.assign, self.choices, self.load = main.assign, main.choices, main.load
        self.spans = main.spans[: packed.n_levels]
        self.down = _Downloader(self)
        self.seg_from, self.seg_min = 0, max(packed.n // 4, 4096)
        self.stats = stats
        if stats is not None:
            stats["n_shards"] = self.D
            stats["runs"] = 0
            stats["shards"] = [{"shard": d, "h2d_bytes": 0, "kernel_ms": 0.0}
                               for d in range(self.D)]

    def codes(self, i0: int, i1: int) -> torch.Tensor:
        """``(assign+1)*4 + choice`` of sorted rows [i0, i1), as
        ``LeveledRun.codes``."""
        out = (self.assign[i0:i1] + 1) * 4 + self.choices[i0:i1].clamp(0, 2)
        return out if self.wide else out.to(torch.int16)

    def _ship(self, host_bufs, Fl: int, waves: list[int]) -> int:
        """Assemble the run's ``[K, F]`` tiles from the ``Tp``-sized host
        arrays and ship each shard exactly its ``[K, Fl]`` slice, and each
        group the run's :func:`wave_table` (``tiles["waves"]``); returns
        K.  Rows of padding waves stay zero."""
        packed, D = self.packed, self.D
        F = Fl * D
        K = _bucket(len(waves), floor=1)
        table = torch.from_numpy(wave_table(packed, waves, K, self.Lp))
        for g in self.groups:
            g.tiles["waves"] = table.to(g.device)
        for (name, dtype), buf in zip(TASK_FIELDS, host_bufs):
            tile = np.zeros((K, F), dtype)
            for i, w in enumerate(waves):
                off = int(packed.offsets[w])
                tile[i] = buf[off: off + F]
            by_shard = tile.reshape(K, D, Fl).transpose(1, 0, 2)
            for g in self.groups:
                g.tiles[name] = torch.from_numpy(
                    np.ascontiguousarray(by_shard[g.shards])).to(g.device)
        if self.stats is not None:
            for d in self.comm.local:
                self.stats["shards"][d]["h2d_bytes"] += K * Fl * TILE_BYTES
            self.stats["runs"] += 1
        return K

    def dispatch(self, host_bufs, Fl: int, waves: list[int], last: bool) -> None:
        """Ship one fused run's tiles, run its waves, and download the rows
        they made final once enough have accumulated (or at the last)."""
        self._ship(host_bufs, Fl, waves)
        self.run_waves(Fl, waves)
        rows_done = int(self.packed.offsets[waves[-1] + 1])
        if rows_done - self.seg_from >= self.seg_min or (last and rows_done > self.seg_from):
            self.down.segment(self.seg_from, rows_done)
            self.seg_from = rows_done

    def reset(self) -> None:
        """The carry back to its state before the first wave."""
        for rep in self.replicas.values():
            rep.assign.fill_(-1)
            rep.choices.fill_(2)
            rep.load.copy_(torch.from_numpy(self.occ_h))
            rep.spans.zero_()

    def run_waves(self, Fl: int, waves: list[int]) -> None:
        """The waves of one fused run on the shipped tiles.  Run mode: one
        launch.  Otherwise, per wave, launch A on every group, psum,
        launch B, psum, then on every replica the load, the span and the
        gathered slices.  A padding wave of the reference's fused run
        (``fs = 0``) skips its body there, so it is not run here."""
        for g in self.groups:
            g.shape_for(Fl)
        if self.mode == "run":
            (g,) = self.groups
            place_shard_run_cuda(g, self.replicas[g.device])
            return
        tentative, contend = self.body or (shard_tentative, shard_contend)
        comm = self.comm
        F = Fl * self.D
        for k, w in enumerate(waves):
            offset, f = int(self.packed.offsets[w]), int(self.sizes[w])
            for g in self.groups:
                tentative(g, self.replicas[g.device], k, f)
            tl = comm.psum(self._rows("tl_part"))
            for g in self.groups:
                contend(g, self.replicas[g.device], k, f, tl.to(g.device))
            wave_load = comm.psum(self._rows("wl_part"))
            afull = comm.all_gather(self._rows("aslice"))
            cfull = comm.all_gather(self._rows("cslice"))
            for dev, rep in self.replicas.items():
                wl = wave_load.to(dev)
                rep.load.add_(wl)
                rep.spans[w] = torch.where(rep.fleet.running, wl * rep.fleet.inv_t, 0.0).max()
                rep.assign[offset: offset + F] = afull.to(dev)
                rep.choices[offset: offset + F] = cfull.to(dev)

    def _rows(self, name: str) -> list[torch.Tensor]:
        """Each local shard's row of a group output, in the comm's order."""
        rows = {}
        for g in self.groups:
            out = getattr(g, name)
            for i, d in enumerate(g.shards):
                rows[d] = out[i]
        return [rows[d] for d in self.comm.local]

    def record_shard_ms(self) -> None:
        """Per-shard completion wall, taken after the last dispatch: shard
        by shard in order, the time until its device has run every launch
        queued so far, so the series is cumulative (a straggler lifts every
        shard behind it), as the reference's probe."""
        if self.stats is None:
            return
        t0 = time.perf_counter()
        for d in self.comm.local:
            dev = self.mesh.devices[d]
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.stats["shards"][d]["kernel_ms"] = round((time.perf_counter() - t0) * 1e3, 3)

    def finalize(self) -> LeveledResult:
        codes, spans_h, load_h = self.down.finish()
        return _finalize(self.packed, codes, spans_h, load_h)


def sharded_pad(T: int, runs, offsets, n_shards: int) -> int:
    """``Tp``: T plus the reference's pad for the runs' full windows."""
    return T + _compute_pad(T, [(Fl * n_shards, ws) for Fl, ws in runs], offsets)


def place_graph_leveled_sharded(
    mesh: EngineMesh,
    packed: PackedGraph,
    nthreads,
    occupancy0,
    running,
    *,
    fleet_dev=None,
    stats: dict | None = None,
    comm=None,
) -> LeveledResult:
    """Place the whole graph over ``mesh``: the reference's
    ``place_graph_leveled_sharded``.  On a 1x1 mesh the result equals
    :func:`~distributed_tpu_torch.ops.leveled.place_graph_leveled`'s bit
    for bit.

    ``fleet_dev`` takes the mirror's ``sharded_device_view`` (capacity-
    sized ``workers``-axis blocks) so a fresh cycle ships zero fleet rows;
    the host fleet arrays are still required and must mirror the device
    rows.  ``stats`` receives ``n_shards``, ``runs`` and per shard
    ``h2d_bytes`` and ``kernel_ms``.  ``comm`` is :class:`LocalShards`
    (the default) or :class:`ProcessGroupShards`.  The mesh's size and
    shape stand in for the reference's ``_mesh_shards``.
    """
    T = packed.n
    D = mesh.size
    runs = _plan_runs_sharded(packed.offsets, D)
    Tp = sharded_pad(T, runs, packed.offsets, D)
    Lp = _bucket(packed.n_levels + 1, floor=64)

    def pad_buf(arr, dtype):
        buf = np.zeros(Tp, dtype)
        buf[:T] = arr
        return buf

    host_bufs = tuple(
        pad_buf(arr, dtype) for arr, (_, dtype) in zip(
            (packed.duration_s, packed.heavy_s, packed.heavy2_s,
             packed.xfer_pref_s, packed.xfer_pref2_s, packed.xfer_all_s), TASK_FIELDS)
    )
    run = ShardedRun(mesh, packed, Tp, Lp, nthreads, occupancy0, running, comm=comm,
                     fleet_dev=fleet_dev, stats=stats)
    for run_i, (Fl, waves) in enumerate(runs):
        run.dispatch(host_bufs, Fl, waves, last=run_i == len(runs) - 1)
    run.record_shard_ms()
    return run.finalize()


def place_graph_streamed_sharded(
    durations,
    out_bytes,
    src,
    dst,
    nthreads,
    occupancy0,
    running,
    mesh: EngineMesh,
    *,
    bandwidth: float = 100e6,
    latency: float = 0.001,
    chunk_rows: int = 131072,
    min_stream: int = 262144,
    timings: dict | None = None,
    fleet_dev=None,
    stats: dict | None = None,
) -> tuple[PackedGraph, LeveledResult]:
    """The mesh branch of the reference's ``place_graph_streamed``
    (``leveled.py:824-830, 861-866, 902-915, 960-963, 1004-1019``), which
    :func:`~distributed_tpu_torch.ops.leveled.place_graph_streamed` calls
    when it is given a mesh.

    Below ``min_stream`` tasks: :func:`pack_graph` then
    :func:`place_graph_leveled_sharded`.  Otherwise the topology pass runs
    on the calling thread and the row fill on a worker thread, into
    ``Tp``-sized host arrays zeroed up front (a run's windows may read rows
    the fill has not reached yet, or the pad tail: padding lanes, which
    must hold no garbage); each fused run whose last wave's rows have been
    filled is dispatched at once, its tiles shipped shard by shard from
    those arrays.  The wire is always the f16 format (``timings["fmt"]``),
    so the result equals the one-shot sharded engine's bit for bit.
    """
    durations, out_bytes, src, dst = _graph_arrays(durations, out_bytes, src, dst)
    T = len(durations)
    t0 = time.perf_counter()
    if T == 0 or T < min_stream:
        packed = pack_graph(durations, out_bytes, src, dst, bandwidth=bandwidth, latency=latency)
        if timings is not None:
            timings.update(topo_s=time.perf_counter() - t0, fmt="f16", fallback=True)
        result = place_graph_leveled_sharded(mesh, packed, nthreads, occupancy0, running,
                                             fleet_dev=fleet_dev, stats=stats)
        if timings is not None:
            timings["total_s"] = time.perf_counter() - t0
        return packed, result
    if len(out_bytes) != T or len(src) != len(dst):
        raise ValueError("durations/out_bytes and src/dst must have equal lengths")
    D = mesh.size
    topo = _StreamPack(durations, out_bytes, src, dst, bandwidth, latency)
    offsets = topo.offsets
    runs = _plan_runs_sharded(offsets, D)
    Tp = sharded_pad(T, runs, offsets, D)
    packed = topo.alloc(Tp, zero=True)
    if timings is not None:
        timings.update(topo_s=time.perf_counter() - t0, fmt="f16")
    run = ShardedRun(mesh, packed, Tp, _bucket(topo.n_levels + 1, floor=64),
                     nthreads, occupancy0, running, fleet_dev=fleet_dev, stats=stats)
    run_i = 0
    try:
        for _, i1 in topo.fill(chunk_rows):
            while run_i < len(runs) and int(offsets[runs[run_i][1][-1] + 1]) <= i1:
                Fl, waves = runs[run_i]
                run.dispatch(topo.bufs, Fl, waves, last=run_i == len(runs) - 1)
                run_i += 1
    finally:
        topo.join()
    if run_i != len(runs):
        raise RuntimeError(f"dispatched {run_i} of {len(runs)} runs")
    run.record_shard_ms()
    result = run.finalize()
    if timings is not None:
        timings.update(fill_wait_s=topo.fill_wait_s, total_s=time.perf_counter() - t0)
    return packed, result
