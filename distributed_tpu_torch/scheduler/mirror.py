"""The scheduler's fleet mirror with its device view on the card (K6).

The port's own copy of ``distributed_tpu/scheduler/mirror.py``'s
``SchedulerMirror``: one persistent structure-of-arrays copy of the fleet
(per-worker ``nthreads``, ``occupancy``, managed ``nbytes``, processing
depth, the ``running``/``idle`` bits and a status code), kept by deltas
from the scheduler's state instead of rebuilt every cycle.

- **Stable slots.**  Every registered worker owns a slot
  (``WorkerState.idx``); tombstoned slots are reused LIFO and capacity
  doubles (never shrinks), so row indices stay valid across cycles.
- **Dirty rows.**  The state's mutation sites call :meth:`mark`;
  :meth:`refresh` re-reads only the dirty rows.  :meth:`verify` holds the
  mirror against the from-scratch pack (:func:`oracle_fleet`).
- **Device view** (:meth:`device_view`).  Capacity-sized tensors on the
  card: one full upload at first use of a field or after growth, then
  only the dirty rows, every field's in one launch of K6
  (``ops/fleet.py``, ``csrc/fleet_scatter.cu``) through a scatter plan
  (``fleet.ScatterPlan``: the tensors, their host rows and a ring of
  pinned record buffers, checked and laid out once) that the mirror
  rebuilds exactly when it uploads in full; a fresh cycle uploads
  nothing.  The reference keeps immutable jax arrays (``.at[rows].set``);
  these tensors are written in place, so the view's readers get them in
  stream order: the upload runs on the calling thread's current stream
  and records :attr:`upload_event`, which a reader on another thread or
  stream waits on before it launches.  The host waits for the card only
  when the ring comes round to a buffer whose launch has not run
  (:attr:`staging_waits`).

:meth:`TorchMirror.adopt` swaps it in for the reference's mirror on a
live ``SchedulerState`` (``state.mirror``), keeping every slot.  The
class is duck-typed against the state and imports nothing of the
reference.

- **Sharded view** (:meth:`sharded_device_view`, K11).  For the sharded
  placement engine (``ops/sharded.py``): the fleet rows split over an
  engine mesh's ``workers`` axis, slot ``s`` in block ``s // (cap // dw)``,
  each block on the device of its shard.  A full pack at first use, on
  growth or on a mesh that is not equal to the last one; otherwise only
  the dirty rows, grouped by owning block.  Unlike :meth:`device_view`,
  a block is never written in place: each dirty block gets a new tensor
  that K11 (the same kernel, one launch a device a view, through a plan a
  device rebuilt at every full pack) fills with the old block and the
  dirty rows (the reference replaces its arrays the same way), so a view
  handed to a plan on another thread never changes under it.  The
  per-shard counters count the exact payload, as ``bytes_uploaded``
  does.  ``plan_builds`` counts the rebuilds of either view's plans: one
  a full upload or pack that lands on the card.
"""

from __future__ import annotations

import bisect
import os
from typing import Any, NamedTuple

import numpy as np
import torch

from distributed_tpu_torch._device import resolve_device
from distributed_tpu_torch.ops import fleet

#: worker status strings -> stable i8 codes (mirror rows are numeric)
STATUS_CODES: dict[str, int] = {
    "running": 0,
    "paused": 1,
    "closing": 2,
    "closing_gracefully": 3,
    "init": 4,
    "closed": 5,
}
STATUS_UNKNOWN = 7

#: fields refreshed per row, in (name, dtype) order: the SoA layout, the
#: oracle rows and the device cache
FIELDS: tuple[tuple[str, Any], ...] = (
    ("nthreads", np.int32),
    ("occupancy", np.float32),
    ("nbytes", np.float32),
    ("nprocessing", np.int32),
    ("running", np.bool_),
    ("idle", np.bool_),
    ("status", np.int8),
)

_MIN_CAP = 8

DEVICE_FIELDS = ("nthreads", "occupancy", "running", "idle")
#: the fields the sharded placement engine reads (the reference's default)
SHARDED_FIELDS = ("nthreads", "occupancy", "running")


class MirrorParityError(AssertionError):
    """Incremental mirror diverged from the from-scratch oracle pack."""


class FleetView(NamedTuple):
    """One refreshed snapshot of the fleet SoA (the mirror's live
    buffers: copy before handing them to another thread)."""

    slots: np.ndarray        # i32[L] live slot indices, ascending
    nthreads: np.ndarray     # i32[cap]
    occupancy: np.ndarray    # f32[cap]
    nbytes: np.ndarray       # f32[cap] managed memory
    nprocessing: np.ndarray  # i32[cap]
    running: np.ndarray      # bool[cap]
    idle: np.ndarray         # bool[cap] (idle AND running: thief-eligible)
    status: np.ndarray       # i8[cap] STATUS_CODES
    addrs: list              # [cap] slot -> address | None
    ws_of: list              # [cap] slot -> WorkerState | None
    live_list: list          # [L] WorkerState in slot order
    live_pos: np.ndarray     # i32[cap] slot -> position in live_list | -1
    n_live: int


def oracle_fleet(state) -> dict[str, tuple]:
    """The from-scratch fleet pack: ``{address: row}`` with exactly the
    dtypes the mirror stores, so the comparison is bit for bit."""
    rows: dict[str, tuple] = {}
    for addr, ws in state.workers.items():
        rows[addr] = (
            np.int32(ws.nthreads),
            np.float32(ws.occupancy),
            np.float32(ws.nbytes),
            np.int32(len(ws.processing)),
            np.bool_(ws in state.running),
            np.bool_(addr in state.idle and ws in state.running),
            np.int8(STATUS_CODES.get(ws.status, STATUS_UNKNOWN)),
        )
    return rows


class TorchMirror:
    """Incrementally maintained SoA mirror of the scheduler's fleet with a
    device view on the card.  ``device=None`` means CUDA and raises here,
    at construction, when there is none; ``device="cpu"`` keeps the view
    in CPU tensors.  ``TorchMirror.launches`` counts the device views
    that wrote to a CUDA device (a row scatter, a full upload or both)."""

    launches = 0
    #: device types whose views write through the plain version (torch
    #: ops); a view on any other device writes through its scatter plan
    #: to the kernel, which raises off CUDA
    PLAIN_DEVICE_TYPES = ("cpu",)

    def __init__(self, state, *, capacity_doubling: bool = True,
                 check: bool | None = None, device=None):
        self.device = resolve_device(device)
        self.state = state
        self.capacity_doubling = capacity_doubling
        #: verify against the from-scratch oracle on every view
        #: (DTPU_MIRROR_CHECK, as the reference reads it)
        self.check = (
            check if check is not None
            else os.environ.get("DTPU_MIRROR_CHECK", "").lower()
            not in ("", "0", "false", "off", "no")
        )
        self.cap = 0
        self._free: list[int] = []     # tombstoned slots, LIFO reuse
        self._next_slot = 0            # high-water mark of ever-used slots
        self._alloc_arrays(_MIN_CAP)
        self.addrs: list = [None] * self.cap
        self.ws_of: list = [None] * self.cap
        self._dirty: set[int] = set()
        self._device_dirty: set[int] = set()
        self._sdev_dirty: set[int] = set()  # the sharded view's dirty rows
        self._members_dirty = True
        self._live_slots = np.zeros(0, np.int32)
        self._live_list: list = []
        self._live_pos = np.full(self.cap, -1, np.int32)
        # device cache: field name -> capacity-sized tensor on self.device
        self._dev: dict[str, torch.Tensor] = {}
        self._dev_cap = -1
        # K6's scatter plan (None on the CPU, whose views take the plain
        # version, and before the first full upload)
        self._plan: fleet.ScatterPlan | None = None
        self._row_bytes = 0            # a row of every cached field
        #: one event a mirror, recorded again on the uploading stream after
        #: every device_view that wrote to the card; None before the first
        self.upload_event: torch.cuda.Event | None = None
        # the sharded view: field -> [dw] blocks, and the mesh and capacity
        # they were packed for
        self._sdev: dict[str, list[torch.Tensor]] = {}
        self._sdev_mesh = None
        self._sdev_cap = -1
        # K11's scatter plans, one a device of the mesh, and each shard's
        # device and group in its device's plan
        self._splans: dict[torch.device, fleet.ScatterPlan] = {}
        self._sgroup: list[tuple[torch.device, int]] = []
        self._retired_waits = 0        # staging waits of plans since rebuilt
        self.plan_builds = 0
        # counters (diagnostics, metrics and tests)
        self.generation = 0
        self.deltas_applied = 0
        self.rows_refreshed = 0
        self.rows_uploaded = 0
        self.bytes_uploaded = 0
        self.full_uploads = 0
        self.membership_rebuilds = 0
        self.dirty_high_water = 0
        self.oracle_checks = 0
        self.oracle_failures = 0
        self.oracle_packs = 0
        # per workers-axis shard of the sharded view: a fresh cycle uploads
        # no row on any shard, and full_packs grows only at growth or a new mesh
        self.shard_rows_uploaded: list[int] = []
        self.shard_bytes_uploaded: list[int] = []
        self.shard_full_packs: list[int] = []

    @classmethod
    def adopt(cls, state, device=None) -> "TorchMirror":
        """Replace the mirror on ``state.mirror`` with a TorchMirror that
        takes over its slot map (slots, free list, high-water mark, host
        rows, pending dirty rows and counters), so every
        ``WorkerState.idx`` stays valid; returns it.  The device view
        starts empty: its first use is a full upload."""
        old = state.mirror
        if old is None:
            raise ValueError("state has no mirror to adopt (it was built with mirror=False)")
        new = cls(state, capacity_doubling=old.capacity_doubling, check=old.check,
                  device=device)
        new.cap = old.cap
        for name, _dtype in FIELDS:
            setattr(new, name, np.array(getattr(old, name), copy=True))
        new._free = list(old._free)
        new._next_slot = old._next_slot
        new.addrs = list(old.addrs)
        new.ws_of = list(old.ws_of)
        new._dirty = set(old._dirty)
        new._members_dirty = True
        new._live_pos = np.full(new.cap, -1, np.int32)
        for name in ("generation", "deltas_applied", "rows_refreshed", "membership_rebuilds",
                     "dirty_high_water", "oracle_checks", "oracle_failures", "oracle_packs"):
            setattr(new, name, getattr(old, name))
        state.mirror = new
        return new

    # ------------------------------------------------------- allocation

    def _alloc_arrays(self, cap: int) -> None:
        self.cap = cap
        for name, dtype in FIELDS:
            setattr(self, name, np.zeros(cap, dtype))

    def _grow(self) -> None:
        new_cap = self.cap * 2 if self.capacity_doubling else self.cap + _MIN_CAP
        for name, _dtype in FIELDS:
            old = getattr(self, name)
            buf = np.zeros(new_cap, old.dtype)
            buf[: self.cap] = old
            setattr(self, name, buf)
        self.addrs.extend([None] * (new_cap - self.cap))
        self.ws_of.extend([None] * (new_cap - self.cap))
        lp = np.full(new_cap, -1, np.int32)
        lp[: self.cap] = self._live_pos
        self._live_pos = lp
        self.cap = new_cap
        # shapes changed: the device caches are rebuilt wholesale (growth
        # also remaps slots to shards: rows per shard doubled)
        self._dev.clear()
        self._device_dirty.clear()
        self._sdev.clear()
        self._sdev_dirty.clear()

    # ---------------------------------------------------- delta sources

    def on_add_worker(self, ws) -> None:
        """Assign a stable slot (tombstone reuse first, then growth)."""
        if self._free:
            slot = self._free.pop()
        else:
            if self._next_slot >= self.cap:
                self._grow()
            slot = self._next_slot
            self._next_slot += 1
        ws.idx = slot
        self.addrs[slot] = ws.address
        self.ws_of[slot] = ws
        self._dirty.add(slot)
        self.deltas_applied += 1
        self._members_dirty = True

    def on_remove_worker(self, ws) -> None:
        """Tombstone the slot; the row zeroes at the next refresh."""
        slot = ws.idx
        if slot < 0 or slot >= len(self.addrs) or self.ws_of[slot] is not ws:
            return
        self.addrs[slot] = None
        self.ws_of[slot] = None
        self._free.append(slot)
        ws.idx = -1
        self._dirty.add(slot)
        self.deltas_applied += 1
        self._members_dirty = True

    def mark(self, ws) -> None:
        """A mirrored field of ``ws`` changed: mark its row dirty."""
        slot = ws.idx
        if slot >= 0:
            self._dirty.add(slot)
            self.deltas_applied += 1

    # ---------------------------------------------------------- refresh

    def refresh(self) -> int:
        """Flush dirty rows from live state into the host SoA; returns the
        number of rows refreshed (0 when the mirror was fresh)."""
        n = len(self._dirty)
        if n == 0:
            return 0
        self.dirty_high_water = max(self.dirty_high_water, n)
        state = self.state
        idle = state.idle
        running = state.running
        for slot in sorted(self._dirty):
            ws = self.ws_of[slot]
            if ws is None:
                self.nthreads[slot] = 0
                self.occupancy[slot] = 0.0
                self.nbytes[slot] = 0.0
                self.nprocessing[slot] = 0
                self.running[slot] = False
                self.idle[slot] = False
                self.status[slot] = STATUS_CODES["closed"]
            else:
                self.nthreads[slot] = ws.nthreads
                self.occupancy[slot] = ws.occupancy
                self.nbytes[slot] = ws.nbytes
                self.nprocessing[slot] = len(ws.processing)
                is_running = ws in running
                self.running[slot] = is_running
                self.idle[slot] = is_running and ws.address in idle
                self.status[slot] = STATUS_CODES.get(ws.status, STATUS_UNKNOWN)
        self._device_dirty.update(self._dirty)
        self._sdev_dirty.update(self._dirty)
        self._dirty.clear()
        self.rows_refreshed += n
        self.generation += 1
        return n

    def _rebuild_membership(self) -> None:
        self._live_slots = np.asarray(
            [s for s, ws in enumerate(self.ws_of) if ws is not None], np.int32,
        )
        self._live_list = [self.ws_of[int(s)] for s in self._live_slots]
        self._live_pos.fill(-1)
        self._live_pos[self._live_slots] = np.arange(len(self._live_slots), dtype=np.int32)
        self._members_dirty = False
        self.membership_rebuilds += 1

    # ------------------------------------------------------------ views

    def fleet_view(self) -> FleetView:
        """Refresh dirty rows and return the shared host snapshot."""
        self.refresh()
        if self._members_dirty:
            self._rebuild_membership()
        if self.check:
            self.verify()
        return FleetView(
            slots=self._live_slots, nthreads=self.nthreads, occupancy=self.occupancy,
            nbytes=self.nbytes, nprocessing=self.nprocessing, running=self.running,
            idle=self.idle, status=self.status, addrs=self.addrs, ws_of=self.ws_of,
            live_list=self._live_list, live_pos=self._live_pos, n_live=len(self._live_list),
        )

    def device_view(self, fields: tuple[str, ...] = DEVICE_FIELDS) -> dict[str, torch.Tensor]:
        """Capacity-sized fleet tensors on the mirror's device, indexed by
        slot: ``{field: tensor}``.  Upload cost per call: nothing when no
        row changed since the last call, the dirty rows otherwise, a full
        upload only at first use of a field or after capacity growth."""
        with self.state.wall.phase("mirror.upload"):
            return self._device_view(fields)

    def _device_view(self, fields: tuple[str, ...]) -> dict[str, torch.Tensor]:
        self.refresh()
        if self._dev_cap != self.cap:
            self._dev.clear()
            self._dev_cap = self.cap
        wrote = False
        # only ever-requested fields live on the card: the rest would ship
        # rows nothing reads.  Off the CPU, ``_dev`` holds tensors only
        # together with the plan built for them
        if self._device_dirty and self._dev:
            n = len(self._device_dirty)
            rows = np.fromiter(self._device_dirty, np.intp, n)
            rows.sort()
            self._scatter(rows)
            self.rows_uploaded += n
            self.bytes_uploaded += n * self._row_bytes
            self.state.trace.emit("kernel", "mirror-upload", "", n=n, dest="scatter")
            wrote = True
        missing = [f for f in fields if f not in self._dev]
        if missing:
            # first use of a field, or growth: a full upload, which carries
            # every past change of that field, and a plan for the new tensors
            for name in missing:
                self._dev[name] = torch.from_numpy(getattr(self, name).copy()).to(self.device)
            self.full_uploads += 1
            self._row_bytes = sum(t.element_size() for t in self._dev.values())
            if self.device.type not in self.PLAIN_DEVICE_TYPES:
                self._retire([self._plan])
                self._plan = None
                names = list(self._dev)
                try:
                    self._plan = fleet.ScatterPlan([[self._dev[f] for f in names]],
                                                   [getattr(self, f) for f in names], copy_on_write=False)
                except BaseException:
                    self._dev.clear()  # the next view uploads in full and builds again
                    raise
                self.plan_builds += 1
            self.state.trace.emit("kernel", "mirror-upload", "", n=self.cap, dest="full")
            wrote = True
        self._device_dirty.clear()
        if wrote and self.device.type == "cuda":
            # one event, recorded again after every view that writes: a
            # reader that waits on it after a later view waits for that
            # view's upload too, which was enqueued after the one it asked
            # for on the same stream, so it waits at least as long as it must
            if self.upload_event is None:
                self.upload_event = torch.cuda.Event()
            self.upload_event.record(torch.cuda.current_stream(self.device))
            TorchMirror.launches += 1
        return {f: self._dev[f] for f in fields}

    def _retire(self, plans) -> None:
        """Keep the staging waits of ``plans`` (None where there was none)
        as they are dropped (their buffers stay until their launches have
        run: ``fleet.ScatterPlan``)."""
        self._retired_waits += sum(p.waits for p in plans if p is not None)

    @property
    def staging_waits(self) -> int:
        """Views that waited for the card to free a record buffer."""
        plans = [self._plan, *self._splans.values()]
        return self._retired_waits + sum(p.waits for p in plans if p is not None)

    def _scatter(self, rows: np.ndarray) -> None:
        """Write the host rows ``rows`` (ascending slots, intp) into the
        cached tensors in place: the plain version on the CPU, one launch
        of K6 through the plan on any other device."""
        if self.device.type in self.PLAIN_DEVICE_TYPES:
            fleet.scatter_rows_reference(fleet.row_jobs(
                list(self._dev.values()), [getattr(self, name) for name in self._dev], rows))
        else:
            fleet.scatter_rows_cuda(self._plan, rows)

    def sharded_device_view(
        self, mesh, fields: tuple[str, ...] = SHARDED_FIELDS,
    ) -> dict[str, list[torch.Tensor]] | None:
        """The fleet rows split over ``mesh``'s ``workers`` axis (an
        ``EngineMesh``): ``{field: [block_0, ..., block_{dw-1}]}``, block
        ``j`` holding slots ``[j*cap/dw, (j+1)*cap/dw)`` on the device of
        shard ``j`` (the first ``tasks`` row of the mesh); the blocks
        joined in order are the capacity-sized field.  ``None`` when
        ``cap % dw != 0``.

        Upload cost per call: nothing when no row changed since the last
        sharded view, the dirty rows grouped by owning shard otherwise
        (each dirty block copied on its device first: a returned block is
        never written), and a full pack per shard at first use, at growth
        or on a mesh not equal to the last one.  The copies run on the
        calling thread's current stream; a reader on another stream waits
        for it (the planner thread and the loop share the default one)."""
        with self.state.wall.phase("mirror.upload"):
            return self._sharded_device_view(mesh, fields)

    def _sharded_device_view(self, mesh, fields: tuple[str, ...]):
        self.refresh()
        n_shards = int(mesh.shape["workers"])
        if n_shards <= 0 or self.cap % n_shards != 0:
            return None
        if len(self.shard_rows_uploaded) != n_shards:
            # first sharded view, or a mesh of another width: the counters restart
            self.shard_rows_uploaded = [0] * n_shards
            self.shard_bytes_uploaded = [0] * n_shards
            self.shard_full_packs = [0] * n_shards
        if self._sdev_cap != self.cap or self._sdev_mesh != mesh:
            # equality, not identity: an equal mesh rebuilt per cycle re-packs nothing
            self._sdev.clear()
            self._sdev_cap = self.cap
            self._sdev_mesh = mesh
        rows_per_shard = self.cap // n_shards
        devices = [mesh.devices[j] for j in range(n_shards)]
        wrote = set()
        if self._sdev_dirty and self._sdev:
            dirty = sorted(self._sdev_dirty)
            cuts = [bisect.bisect_left(dirty, j * rows_per_shard) for j in range(n_shards + 1)]
            names = list(self._sdev)
            hosts = [getattr(self, name) for name in names]
            row_bytes = sum(h.itemsize for h in hosts)
            # a new block a dirty (shard, field), filled by one launch a device
            parts: dict[torch.device, list[fleet.Part]] = {}
            for j in range(n_shards):
                if cuts[j] == cuts[j + 1]:
                    continue
                rows = np.array(dirty[cuts[j]:cuts[j + 1]], np.intp)
                src = [self._sdev[name][j] for name in names]
                dst = [torch.empty_like(b) for b in src]
                for name, block in zip(names, dst):
                    self._sdev[name][j] = block
                dev, g = self._sgroup[j]
                parts.setdefault(dev, []).append(fleet.Part(g, j * rows_per_shard, rows, dst, src))
                self.shard_bytes_uploaded[j] += len(rows) * row_bytes
                self.shard_rows_uploaded[j] += len(rows)
                wrote.add(devices[j])
            try:
                for dev, dev_parts in parts.items():
                    if dev.type in self.PLAIN_DEVICE_TYPES:
                        fleet.scatter_rows_reference(fleet.part_jobs(dev_parts, hosts))
                    else:
                        fleet.scatter_blocks_cuda(self._splans[dev], dev_parts)
            except BaseException:
                # the new blocks are in place but not all filled: the next
                # view packs in full
                self._sdev.clear()
                raise
            self.rows_uploaded += len(self._sdev_dirty)
            self.state.trace.emit("kernel", "mirror-upload", "", n=len(self._sdev_dirty),
                                  dest="shard-scatter")
        missing = [f for f in fields if f not in self._sdev]
        if missing:
            for name in missing:
                host = getattr(self, name)
                self._sdev[name] = [
                    torch.from_numpy(host[j * rows_per_shard:(j + 1) * rows_per_shard].copy())
                    .to(devices[j]) for j in range(n_shards)
                ]
            for j in range(n_shards):
                self.shard_full_packs[j] += 1
            self.full_uploads += 1
            self._shard_plans(devices)
            self.state.trace.emit("kernel", "mirror-upload", "", n=self.cap, dest="shard-full")
            wrote.update(devices)
        self._sdev_dirty.clear()
        if any(d.type == "cuda" for d in wrote):
            TorchMirror.launches += 1
        return {f: list(self._sdev[f]) for f in fields}

    def _shard_plans(self, devices: list[torch.device]) -> None:
        """K11's plans after a full pack: one a device off the CPU, its
        groups that device's shards in order."""
        self._retire(self._splans.values())
        self._splans = {}
        self._sgroup = []
        names = list(self._sdev)
        on: dict[torch.device, list[int]] = {}
        for j, dev in enumerate(devices):
            self._sgroup.append((dev, len(on.setdefault(dev, []))))
            on[dev].append(j)
        hosts = [getattr(self, name) for name in names]
        try:
            for dev, shards in on.items():
                if dev.type not in self.PLAIN_DEVICE_TYPES:
                    self._splans[dev] = fleet.ScatterPlan(
                        [[self._sdev[name][j] for name in names] for j in shards], hosts, copy_on_write=True)
        except BaseException:
            self._sdev.clear()  # the next view packs in full and builds again
            raise
        if self._splans:
            self.plan_builds += 1

    def sharded_stats(self) -> dict[str, Any]:
        """Per-shard upload counters of :meth:`sharded_device_view` (empty
        lists before its first call), one entry per ``workers`` shard."""
        return {
            "n_shards": len(self.shard_rows_uploaded),
            "rows_uploaded": list(self.shard_rows_uploaded),
            "bytes_uploaded": list(self.shard_bytes_uploaded),
            "full_packs": list(self.shard_full_packs),
        }

    # ----------------------------------------------------------- oracle

    def verify(self) -> None:
        """Assert the incremental mirror equals the from-scratch pack bit
        for bit (raises :class:`MirrorParityError`), pending rows flushed
        first: the claim is that the dirty marking is complete."""
        self.refresh()
        self.oracle_checks += 1
        rows = oracle_fleet(self.state)
        try:
            live = [s for s in range(len(self.addrs)) if self.ws_of[s] is not None]
            assert len(live) == len(rows), f"live slots {len(live)} != workers {len(rows)}"
            for slot in live:
                ws = self.ws_of[slot]
                assert ws.idx == slot, (ws, slot, ws.idx)
                addr = self.addrs[slot]
                assert addr == ws.address, (addr, ws.address)
                got = tuple(getattr(self, name)[slot] for name, _ in FIELDS)
                for (name, _), e, g in zip(FIELDS, rows[addr], got):
                    assert e == g and type(e) == type(g), (
                        f"{addr} slot {slot} field {name}: mirror={g!r} oracle={e!r}"
                    )
            for slot in self._free:
                assert self.ws_of[slot] is None and self.addrs[slot] is None, slot
        except AssertionError as e:
            self.oracle_failures += 1
            raise MirrorParityError(str(e)) from e

    def stats(self) -> dict[str, int]:
        """Counter snapshot for diagnostics and tests."""
        return {
            "generation": self.generation,
            "capacity": self.cap,
            "workers_live": int(len(self.state.workers)),
            "deltas_applied": self.deltas_applied,
            "rows_refreshed": self.rows_refreshed,
            "rows_uploaded": self.rows_uploaded,
            "bytes_uploaded": self.bytes_uploaded,
            "full_uploads": self.full_uploads,
            "membership_rebuilds": self.membership_rebuilds,
            "dirty_high_water": self.dirty_high_water,
            "oracle_checks": self.oracle_checks,
            "oracle_failures": self.oracle_failures,
            "oracle_packs": self.oracle_packs,
        }

    def __repr__(self) -> str:
        return (
            f"<TorchMirror cap={self.cap} live={len(self.state.workers)} "
            f"gen={self.generation} dirty={len(self._dirty)} device={self.device}>"
        )
