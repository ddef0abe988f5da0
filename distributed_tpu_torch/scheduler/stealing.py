"""Work stealing's device path on the card, bound onto the scheduler's
``WorkStealing`` extension.

The port's own copies of the reference's ``WorkStealing._balance_cycle``,
``_balance_device`` and ``_device_plan_landed``
(``distributed_tpu/scheduler/stealing.py:488-579,595-846``), installed on
the extension *instance* by :func:`install_stealing` (the port cannot
subclass the reference's class).  The extension's own ``balance``,
``_apply_device_plan`` and ``_steal_pays`` stay: they hold no JAX.

What differs from the reference:

- the gate is :class:`~distributed_tpu_torch.scheduler.gate.DevicePath`'s
  explicit parameters rather than the reference's configuration;
- the fleet comes from the :class:`~distributed_tpu_torch.scheduler.mirror.TorchMirror`'s
  device view (the state's mirror is adopted when it is another kind);
  the in-flight overlay is added out of place (``index_add``), so the
  cached occupancy never absorbs it;
- the plan (``ops/stealing.py::plan_steals``, kernel K7 on the card) runs
  on the port's daemon executor, after waiting on the mirror's upload
  event, so upload and launch are ordered whatever thread or stream each
  runs on;
- no ``except`` swallows a failure of the device path: it is counted in
  ``failures``, kept in ``errors`` and raised, out of ``balance()`` (or,
  for a plan computed off the loop, out of the callback that lands it).
"""

from __future__ import annotations

import asyncio
import functools
from typing import Any

import numpy as np
import torch

from distributed_tpu_torch._device import resolve_device
from distributed_tpu_torch.ops import stealing as ops_stealing
from distributed_tpu_torch.ops.stealing import _RANK_BITS, LATENCY
from distributed_tpu_torch.scheduler.gate import DevicePath
from distributed_tpu_torch.scheduler.mirror import DEVICE_FIELDS, TorchMirror
from distributed_tpu_torch.scheduler.torch_placement import _DaemonExecutor


def ensure_mirror(state, device) -> TorchMirror | None:
    """The state's mirror as a :class:`TorchMirror` on ``device``: adopted
    from the mirror the state has, kept if it already is one; None when
    the state runs without a mirror."""
    mirror = state.mirror
    if mirror is None or isinstance(mirror, TorchMirror):
        return mirror
    return TorchMirror.adopt(state, device=device)


class StealingPath(DevicePath):
    """The device path of one ``WorkStealing`` instance."""

    def __init__(self, device=None, **gate):
        super().__init__(resolve_device(device), **gate)

    # ------------------------------------------------------------- cycle

    def balance_cycle(self, ext) -> None:
        """One stealing cycle (the reference's ``_balance_cycle``)."""
        ext._last_balance = ext.clock()
        s = ext.state
        if not s.idle or len(s.workers) < 2:
            return
        idle_workers = [ws for ws in s.idle.values() if ws in s.running]
        if not idle_workers:
            return
        n_stealable = sum(len(t) for levels in ext.stealable.values() for t in levels)
        if not n_stealable:
            return
        if ext._device_plan_inflight:
            # a plan for a snapshot a few ms old is being computed off the
            # loop; python steals on top would double-move
            return
        if self.worthwhile(len(s.workers), n_stealable, ext.DEVICE_MIN_TASKS):
            self.cycles_device += 1
            try:
                self.balance_device(ext, idle_workers)
            except Exception as exc:
                self.fail(exc)
                raise
            return
        self.cycles_host += 1
        s.trace.emit("kernel", "steal-cycle", "", n=n_stealable, dest="host")
        if s.saturated:
            victims = list(s.saturated)
        else:
            victims = sorted(
                (ws for ws in s.workers.values() if ws.processing and ws not in s.idle.values()),
                key=lambda ws: ws.occupancy / max(ws.nthreads, 1),
                reverse=True,
            )[:10]
        start = ext.clock()
        for victim in victims:
            levels = ext.stealable.get(victim.address)
            if levels is None:
                continue
            for level, tasks in enumerate(levels):
                if not tasks:
                    continue
                for ts in list(tasks):
                    if not idle_workers:
                        return
                    if ts.key in ext.in_flight or ts.processing_on is not victim:
                        tasks.discard(ts)
                        continue
                    thief = ext._get_thief(ts, idle_workers)
                    if thief is None:
                        continue
                    occ_thief = ext._combined_occupancy(thief)
                    occ_victim = ext._combined_occupancy(victim)
                    comm_cost_thief = s.get_comm_cost(ts, thief)
                    compute = s.get_task_duration(ts)
                    if (
                        occ_thief / max(thief.nthreads, 1) + comm_cost_thief + compute
                        <= occ_victim / max(victim.nthreads, 1) - compute / 2
                    ):
                        if (
                            ext.speculative
                            and len(victim.processing) >= 4 * victim.nthreads
                            and not ts.actor
                            and not ts.resource_restrictions
                        ):
                            ext.move_task_speculative(ts, victim, thief)
                        else:
                            ext.move_task_request(ts, victim, thief)
                        occ_thief = ext._combined_occupancy(thief)
                        if occ_thief / max(thief.nthreads, 1) > LATENCY:
                            idle_workers = [w for w in idle_workers if w is not thief]
            if ext.clock() - start > 0.05:  # bound cycle time like the reference
                break

    # ------------------------------------------------------------ device

    def balance_device(self, ext, idle_workers: list) -> None:
        """One balance cycle through ``plan_steals`` (the reference's
        ``_balance_device``): the fleet from the mirror, the stealable
        tasks priced on the loop, the plan on the card, and the moves
        re-validated on the loop by ``_apply_device_plan``."""
        max_rank = (1 << _RANK_BITS) - 1
        s = ext.state
        s.trace.emit("kernel", "steal-cycle", "", n=len(idle_workers), dest="device")
        mirror = ensure_mirror(s, self.device)
        overlay_slots: list[int] = []
        overlay_vals: list[float] = []
        if mirror is not None:
            fv = mirror.fleet_view()
            nthreads_arr = fv.nthreads
            running_arr = fv.running
            idle_arr = fv.idle
            nprocessing = fv.nprocessing
            # a snapshot: tombstone slots may be reused before the plan lands
            ws_of: list = list(fv.ws_of)
            for w, extra in ext.in_flight_occupancy.items():
                if w.idx >= 0:
                    overlay_slots.append(w.idx)
                    overlay_vals.append(extra)
            if overlay_slots:
                occ_arr = fv.occupancy.copy()
                occ_arr[overlay_slots] += overlay_vals
            else:
                occ_arr = fv.occupancy
            slot_of = None  # WorkerState.idx is the slot
        else:
            # the from-scratch pack (the state runs without a mirror)
            workers = list(s.workers.values())
            idle_set = set(idle_workers)
            slot_of = {ws.address: i for i, ws in enumerate(workers)}
            ws_of = workers
            occ_arr = np.asarray([ext._combined_occupancy(ws) for ws in workers], np.float32)
            nthreads_arr = np.asarray([ws.nthreads for ws in workers], np.int32)
            idle_arr = np.asarray([ws in idle_set for ws in workers], bool)
            running_arr = np.asarray([ws in s.running for ws in workers], bool)
            nprocessing = np.asarray([len(ws.processing) for ws in workers], np.int32)

        if s.saturated:
            victim_slots = [
                ws.idx if slot_of is None else slot_of.get(ws.address, -1) for ws in s.saturated
            ]
            victim_slots = [v for v in victim_slots if v >= 0]
        else:
            vload = occ_arr / np.maximum(nthreads_arr, 1)
            # not filtered on running: a paused worker's pile is drained too
            cand = np.flatnonzero((nprocessing > 0) & ~idle_arr)
            victim_slots = cand[np.argsort(-vload[cand], kind="stable")].tolist()
        victim_slots = victim_slots[: ext.DEVICE_MAX_VICTIMS]

        tasks: list = []
        victim_idx: list[int] = []
        keys: list[int] = []
        costs: list[float] = []
        computes: list[float] = []
        alt_thief: list[int] = []
        rank = 0
        scan_cap = ext.DEVICE_RESIDENT_SCAN_MAX_DEPS
        holder_cap = ext.DEVICE_RESIDENT_SCAN_MAX_HOLDERS
        bandwidth = s.bandwidth
        # per-dependency idle-holder bytes, once per distinct dep a cycle
        dep_memo: dict[Any, dict[int, float]] = {}
        for vi in victim_slots:
            vws = ws_of[int(vi)]
            if vws is None:
                continue
            levels = ext.stealable.get(vws.address)
            if levels is None:
                continue
            if rank >= ext.DEVICE_MAX_TASKS:
                break
            for level, tset in enumerate(levels):
                for ts in list(tset):
                    if rank >= ext.DEVICE_MAX_TASKS:
                        break
                    if ts.key in ext.in_flight or ts.processing_on is not vws:
                        tset.discard(ts)
                        continue
                    compute = s.get_task_duration(ts)
                    # price the best idle thief (the one holding the most
                    # dependency bytes); the apply step re-checks with the
                    # true per-thief cost and may fall back to it (alt)
                    nbytes = 0.0
                    best_slot = -1
                    if len(ts.dependencies) <= scan_cap:
                        resident: dict[int, float] = {}
                        for d in ts.dependencies:
                            nb = d.get_nbytes()
                            nbytes += nb
                            per_dep = dep_memo.get(d)
                            if per_dep is None:
                                per_dep = {}
                                if len(d.who_has) <= holder_cap:
                                    for h in d.who_has:
                                        hi = h.idx if slot_of is None else slot_of.get(h.address, -1)
                                        if hi >= 0 and idle_arr[hi]:
                                            per_dep[hi] = nb
                                dep_memo[d] = per_dep
                            for hi, hb in per_dep.items():
                                resident[hi] = resident.get(hi, 0.0) + hb
                        best_bytes = 0.0
                        for hi, rb in resident.items():
                            if rb > best_bytes:
                                best_bytes, best_slot = rb, hi
                        nbytes -= best_bytes
                    else:
                        nbytes = float(sum(d.get_nbytes() for d in ts.dependencies))
                    tasks.append(ts)
                    victim_idx.append(int(vi))
                    keys.append((level << _RANK_BITS) | min(rank, max_rank))
                    costs.append(nbytes / bandwidth + LATENCY)
                    computes.append(compute)
                    alt_thief.append(best_slot)
                    rank += 1
        if not tasks:
            return
        occ_kernel: Any = np.asarray(occ_arr, np.float32)
        nthreads_kernel: Any = nthreads_arr
        idle_kernel: Any = idle_arr
        running_kernel: Any = running_arr
        upload = None
        if mirror is not None:
            # the resident fleet: only rows dirtied since the last cycle
            # are uploaded; the overlay is added out of place
            dv = mirror.device_view(DEVICE_FIELDS)
            occ_kernel = dv["occupancy"]
            if overlay_slots:
                occ_kernel = occ_kernel.index_add(
                    0, torch.as_tensor(overlay_slots, dtype=torch.long).to(self.device),
                    torch.as_tensor(np.asarray(overlay_vals, np.float32)).to(self.device),
                )
            nthreads_kernel = dv["nthreads"]
            idle_kernel = dv["idle"]
            running_kernel = dv["running"]
            upload = mirror.upload_event
        batch = ops_stealing.StealBatch(
            task_victim=np.asarray(victim_idx, np.int32),
            task_key=np.asarray(keys, np.int32),
            task_cost=np.asarray(costs, np.float32),
            task_compute=np.asarray(computes, np.float32),
            occ=occ_kernel,
            nthreads=nthreads_kernel,
            idle=idle_kernel,
            running=running_kernel,
        )
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            # no loop (sync tests): plan inline
            ext._apply_device_plan(self.plan(batch, upload), tasks, ws_of, alt_thief)
            return
        if ext._device_executor is None:
            ext._device_executor = _DaemonExecutor("steal-device")
        ext._device_plan_inflight = True
        fut = ext._device_executor.submit(self.plan, batch, upload)

        def _done(f):
            try:
                loop.call_soon_threadsafe(ext._device_plan_landed, f, tasks, ws_of, alt_thief)
            except RuntimeError:
                ext._device_plan_inflight = False  # loop closed

        fut.add_done_callback(_done)

    def plan(self, batch, upload=None) -> np.ndarray:
        """The cycle's plan on the path's device, on the calling thread:
        its stream first waits for the mirror's upload."""
        if upload is not None:
            torch.cuda.current_stream(self.device).wait_event(upload)
        thief_of = ops_stealing.plan_steals(batch, device=self.device)
        self.launches += 1
        return thief_of

    def device_plan_landed(self, ext, fut, tasks: list, ws_of: list, alt_thief: list) -> None:
        """Apply a plan computed off the loop; a failed plan is counted and
        raised (the reference logs it and carries on)."""
        ext._device_plan_inflight = False
        if fut.cancelled():
            return
        exc = fut.exception()
        if exc is not None:
            self.fail(exc)
            raise exc
        ext._apply_device_plan(fut.result(), tasks, ws_of, alt_thief)


def install_stealing(ext, device=None, **options) -> StealingPath:
    """Bind the port's device path onto the ``WorkStealing`` instance
    ``ext`` and return it.  ``options`` go to :class:`StealingPath` (the
    gate's ``enabled``, ``min_workers`` and ``periodic_min_workers``);
    ``device=None`` means CUDA and raises without one.  The
    state's mirror is adopted as a :class:`TorchMirror` on the device."""
    path = StealingPath(device, **options)
    ensure_mirror(ext.state, path.device)
    ext._balance_cycle = functools.partial(path.balance_cycle, ext)
    ext._balance_device = functools.partial(path.balance_device, ext)
    ext._device_plan_landed = functools.partial(path.device_plan_landed, ext)
    return path
