"""Whole-graph placement on the card behind the scheduler's placement hook.

The port's own copy of ``distributed_tpu/scheduler/jax_placement.py``'s
``JaxPlacement``, mesh branch included.  Inject it with
``Scheduler(placement=TorchPlacement())`` (or a ``LocalCluster``'s
``scheduler_kwargs={"placement": ...}``): the scheduler's state calls
``plan_graph`` at ``update_graph`` time and consults the hints through
``wants``/``resolve``/``decide_worker``.  It is duck-typed against the
reference's ``SchedulerState`` and imports nothing of it.

``plan_graph`` snapshots the batch into arrays on the event loop (cheap)
and hands ``_plan_from_arrays`` to a daemon planner thread, so the card
never blocks scheduling; ``sync=True`` plans on the loop (deterministic
tests).  ``_plan_from_arrays`` routes a batch as the reference does:

- while the dense score matrix fits (``_bucket(T) * lanes <=
  DENSE_LIMIT``), the partitioner (``ops/partition.py``, kernel K4) and
  absolute home hints ``(None, addr)``;
- otherwise the leveled engine (``scheduler/plan.py`` on the streamed
  driver, kernel K1) and follow-this-dependency hints; with an engine
  mesh, the streamed driver's mesh branch (``ops/sharded.py``, kernel
  K10 on every shard), fed by the mirror's workers-axis view (K11) when
  the state's mirror is a :class:`TorchMirror`, and the per-shard stats
  go to ``state.observe_engine_shards``.

The mesh (``mesh_enabled``/``mesh_devices``/``mesh_layout``, the
reference's ``scheduler.jax.mesh`` defaults, plus ``mesh_shard_devices``
for shards that share a device) is built at construction: ``"auto"``
turns it on only when at least two devices are visible, and a layout
that cannot be satisfied raises there.

A failure of either engine propagates: the planner logs it and disables
itself (``enabled`` turns False), as the reference's handler does, and
the scheduler's python oracle carries the graphs from then on.  The
reference's fallbacks are not copied, neither its numpy partitioner
after a failed device partition nor its single-device engine after a
failed sharded one or an unsatisfiable mesh: a missing or broken card
must show, not be absorbed.

The constructor reads the port's ``scheduler.jax`` configuration for
every argument it is not given, as the reference's does.  A hint is a
speculative placement: tasks the oracle places before a plan lands
simply miss it.
"""

from __future__ import annotations

import asyncio
import atexit
import contextlib
import logging
import math
import queue
import threading
from concurrent.futures import Future
from typing import Any

import numpy as np
import torch

from distributed_tpu_torch import config
from distributed_tpu_torch._device import resolve_device
from distributed_tpu_torch.ops import partition as part
from distributed_tpu_torch.scheduler import plan as planning
from distributed_tpu_torch.scheduler.mirror import TorchMirror

logger = logging.getLogger("distributed_tpu_torch.placement")

_DEFAULT_NBYTES = 10_000.0  # cost-model guess for unobserved outputs

#: atexit grace for an in-flight plan: long enough for a plan on the card
#: to drain, short enough that a wedged device cannot pin the exit
_EXIT_DRAIN_S = 15.0

_PENDING = ("released", "waiting", "queued", "no-worker")


def _cfg(value, key: str):
    """An explicit argument, else the configuration's ``key``."""
    return value if value is not None else config.get(key)


def _check_partitioner(name: str) -> str:
    if name not in ("auto", "numpy", "off"):
        raise ValueError(f"partitioner {name!r}: expected auto, numpy or off")
    return name


class _DaemonExecutor:
    """Single daemon-thread executor with the slice of the
    ``concurrent.futures`` API the planner uses (submit/shutdown).

    ThreadPoolExecutor threads are joined at interpreter exit, so a plan
    blocked on a wedged device would pin the process.  A daemon thread
    dies with the process; an atexit hook first waits a bounded
    ``_EXIT_DRAIN_S`` for the job in flight, so a normal plan drains
    before teardown."""

    def __init__(self, name: str):
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._idle = threading.Event()
        self._idle.set()
        self._pending = 0  # queued + running jobs, under _lock
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()
        atexit.register(self._drain_at_exit)

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fut, fn, args = item
            try:
                if not fut.set_running_or_notify_cancel():
                    continue
                try:
                    fut.set_result(fn(*args))
                except BaseException as exc:  # noqa: BLE001 - to waiter
                    fut.set_exception(exc)
            finally:
                with self._lock:
                    self._pending -= 1
                    if self._pending == 0:
                        self._idle.set()

    def _drain_at_exit(self) -> None:
        self._idle.wait(_EXIT_DRAIN_S)

    def submit(self, fn, *args) -> Future:
        fut: Future = Future()
        with self._lock:
            self._pending += 1
            self._idle.clear()
        self._q.put((fut, fn, args))
        return fut

    def shutdown(self, wait: bool = False, cancel_futures: bool = False) -> None:
        # the reference's WorkStealing.close passes both; like the
        # reference's executor this one neither waits nor cancels
        self._q.put(None)
        if self._idle.is_set():
            # nothing in flight: drop the exit hook so repeated
            # create/close cycles don't accumulate registrations; with a
            # job still running the hook stays
            atexit.unregister(self._drain_at_exit)


class TorchPlacement:
    """Whole-graph planner on the card behind the ``SchedulerState``
    placement hook.

    ``min_batch``/``max_batch``: planned batch sizes; ``min_workers``:
    the fleet below which the python oracle places alone;
    ``min_transfer_ratio``: skip graphs whose mean transfer cost is below
    this fraction of the mean task duration (0 disables); ``partitioner``:
    ``"auto"`` (the partitioner on ``device``: K4 on the card, its plain
    version on an explicit CPU device), ``"numpy"`` (the reference's numpy
    engine) or ``"off"`` (always the leveled engine); ``home_depth``:
    ``"inf"`` stacks every hinted task on its home, an int parks tasks
    beyond ``ceil(nthreads * saturation) + home_depth * nthreads``;
    ``drift_yield``: let a home that is an extreme backlog outlier yield to
    an idle worker.  ``device=None`` means CUDA and raises here, at
    construction, when there is none.

    ``mesh_enabled``: ``"auto"`` (the sharded engine when at least two
    devices are visible), ``True`` or ``False``; ``mesh_devices``: how
    many of them (0: all); ``mesh_layout``: ``"auto"`` or ``"TxW"``;
    ``mesh_shard_devices``: the shards' devices, one entry a shard and
    repeats allowed (several shards on one card), instead of the visible
    devices of ``device``'s type.

    As in the reference (``jax_placement.py:160-201``), every argument
    but ``max_batch``, ``device`` and ``mesh_shard_devices`` left None
    is read from ``scheduler.jax.<key>`` (``min-batch``, ``min-workers``,
    ``sync-plan``, ``min-transfer-ratio``, ``home-depth``,
    ``drift-yield``, ``mesh.*``) at construction, and ``partitioner``
    from ``scheduler.jax.partitioner`` at each plan; an explicit
    argument wins.
    """

    def __init__(self, min_batch: int | None = None, max_batch: int | None = None,
                 min_workers: int | None = None, sync: bool | None = None,
                 min_transfer_ratio: float | None = None, partitioner: str | None = None,
                 home_depth: int | str | None = None, drift_yield: bool | None = None,
                 device=None, mesh_enabled: bool | str | None = None,
                 mesh_devices: int | None = None, mesh_layout: str | None = None,
                 mesh_shard_devices=None):
        if partitioner is not None:
            _check_partitioner(partitioner)
        self.device = resolve_device(device)
        # "auto" (any non-boolean) is None: the sharded engine when at
        # least two devices are visible
        mesh_enabled = _cfg(mesh_enabled, "scheduler.jax.mesh.enabled")
        self.mesh_enabled: bool | None = (
            mesh_enabled if isinstance(mesh_enabled, bool) else None
        )
        self.mesh_devices = int(_cfg(mesh_devices, "scheduler.jax.mesh.devices"))
        self.mesh_layout = str(_cfg(mesh_layout, "scheduler.jax.mesh.layout"))
        self.mesh_shard_devices = mesh_shard_devices
        self._mesh = self._get_mesh()
        self.min_batch = _cfg(min_batch, "scheduler.jax.min-batch")
        self.max_batch = max_batch or 1_000_000
        self.min_workers = _cfg(min_workers, "scheduler.jax.min-workers")
        self.sync = bool(_cfg(sync, "scheduler.jax.sync-plan"))
        self.min_transfer_ratio = float(
            _cfg(min_transfer_ratio, "scheduler.jax.min-transfer-ratio"))
        # None: ``scheduler.jax.partitioner``, read at plan time
        self.partitioner = partitioner
        hd = _cfg(home_depth, "scheduler.jax.home-depth")
        self.home_depth: int | None = None if hd in ("inf", None) else int(hd)
        self.drift_yield = bool(_cfg(drift_yield, "scheduler.jax.drift-yield"))
        self.plan: dict[Any, tuple] = {}
        # stimulus id of the most recently LANDED plan: the decision
        # ledger stamps it onto every plan-homed placement row
        self.plan_stim: str = ""
        self.plans_computed = 0
        self.plan_hits = 0
        self.plan_misses = 0
        self.plan_parks = 0
        self.plans_inflight = 0
        # why CONSULTED hints were refused (these partition plan_misses)
        self.miss_reasons: dict[str, int] = {
            "worker-gone": 0, "restricted": 0, "dep-moved": 0,
            "idle-yield": 0, "park-declined": 0,
        }
        # hints discarded WITHOUT being consulted: pruned as stale, or
        # landed after the oracle had already placed them
        self.hint_drops: dict[str, int] = {"stale-dropped": 0, "landed-late": 0}
        self.enabled = True
        self._executor: _DaemonExecutor | None = None

    # ------------------------------------------------------------- hooks

    def on_add_worker(self, state, ws) -> None:
        pass  # plans stay valid as hints; new workers fill via stealing

    def on_remove_worker(self, state, ws) -> None:
        # follow-dep hints survive a departure (the dep re-resolves
        # against live replicas); only hints pinned to the dead worker go
        addr = ws.address
        self.plan = {
            k: a for k, a in self.plan.items() if a[0] is not None or a[1] != addr
        }

    # -------------------------------------------------------------- mesh

    def _get_mesh(self):
        """The engine mesh (built once, at construction), or None when the
        mesh branch is off: on ``mesh_shard_devices``, else every visible
        device of ``device``'s type."""
        if self.mesh_enabled is False:
            return None
        if self.mesh_shard_devices is not None:
            devices = list(self.mesh_shard_devices)
        elif self.device.type == "cuda":
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            devices = [self.device]
        if self.mesh_enabled is None and len(devices) < 2:
            # auto on one device: the single-device engine (a 1x1 mesh
            # places the same, with two launches a wave instead of one a graph)
            return None
        return part.make_engine_mesh(self.mesh_devices or None, self.mesh_layout,
                                     devices=devices)

    def wants(self, ts) -> bool:
        return self.enabled and ts.key in self.plan

    # -------------------------------------------------------- consumption
    #
    #   open slot on the home worker  -> place there (hit)
    #   home busy, short backlog      -> PARK: the task queues scheduler-
    #                                    side and the home pulls it at its
    #                                    next slot-open
    #   home backlog beyond slack     -> the plan drifted from live load:
    #                                    yield to the idle worker

    def resolve(self, state, ts, valid_workers):
        """(verdict, ws): ("hit", ws) place now; ("park", ws) defer to
        ws's queue-pull; ("miss", None) hint unusable, use the oracle.
        The single consumption point of both transition drivers."""
        entry = self.plan.get(ts.key)
        if entry is None:
            return "miss", None
        follow_key, addr = entry
        if follow_key is not None:
            # locality hint: follow the chosen dependency to its LIVE
            # location, preferring a holder that satisfies restrictions
            dts = state.tasks.get(follow_key)
            ws = None
            if dts is not None and dts.who_has:
                for cand in dts.who_has:
                    if cand in state.running and (
                        valid_workers is None or cand in valid_workers
                    ):
                        ws = cand
                        break
            if ws is None:
                return self._miss(
                    ts,
                    "restricted"
                    if dts is not None and any(c in state.running for c in dts.who_has)
                    else "dep-moved",
                )
        else:
            ws = state.workers.get(addr)
            if ws is None or ws not in state.running:
                return self._miss(ts, "worker-gone")
            if valid_workers is not None and ws not in valid_workers:
                return self._miss(ts, "restricted")

        # drift check first: the home loses its claim only when it is an
        # OUTLIER against the cluster-average backlog
        backlog = ws.occupancy / max(ws.nthreads, 1)
        avg = (
            state.total_occupancy / state.total_nthreads if state.total_nthreads else 0.0
        )
        if self.home_depth is None:
            # deep-stack mode: only an extreme, persistent outlier sheds
            slack = 4.0 * avg + max(
                8 * state.transfer_latency, 2 * state.get_task_duration(ts), 2.0,
            )
        else:
            slack = avg + max(8 * state.transfer_latency, 2 * state.get_task_duration(ts))
        if backlog > slack and state.idle and self.drift_yield:
            idle_ws = next(iter(state.idle.values()))
            bw = state.bandwidth
            lat = state.transfer_latency

            def objective(w) -> float:
                missing = 0.0
                n_missing = 0
                for dts in ts.dependencies:
                    if w not in dts.who_has:
                        n_missing += 1
                        if dts.nbytes > 0:
                            missing += dts.nbytes
                # a fetch pays a fixed latency whatever its size, so the
                # hint wins ties whenever following it avoids transfers
                return w.occupancy / max(w.nthreads, 1) + missing / bw + n_missing * lat

            if objective(idle_ws) < objective(ws):
                return self._miss(ts, "idle-yield")

        # the home accepts a stack beyond the open-slot line ("inf": no
        # parking at all; home-placed tasks are exempt from stealing)
        if self.home_depth is None:
            depth = float("inf")
        else:
            sat = state.WORKER_SATURATION
            depth = (
                math.ceil(ws.nthreads * sat) if math.isfinite(sat) else 2 * ws.nthreads
            ) + self.home_depth * ws.nthreads
        if len(ws.processing) < depth:
            del self.plan[ts.key]
            self.plan_hits += 1
            # "plan" provenance: the steal exemption, and the ledger's
            # row kind
            ts.homed = "plan" if follow_key is None else False
            return "hit", ws
        self.plan_parks += 1
        return "park", ws

    def _miss(self, ts, reason: str):
        self.plan.pop(ts.key, None)
        self.plan_misses += 1
        self.miss_reasons[reason] += 1
        return "miss", None

    def decide_worker(self, state, ts, valid_workers):
        """Legacy entry (no-worker recovery): hit-or-miss only.  A would-be
        park is consumed as a miss, since the caller is about to place the
        task elsewhere."""
        verdict, ws = self.resolve(state, ts, valid_workers)
        if verdict == "park":
            self.plan_parks -= 1
            self._miss(ts, "park-declined")
            return None
        return ws if verdict == "hit" else None

    # ---------------------------------------------------------- planning

    def plan_graph(self, state, tasks: dict, stimulus_id: str = "") -> int:
        """Plan the batch; returns the tasks planned on the loop (0 when
        the plan is computed off the loop, or not at all)."""
        if not self.enabled:
            return 0
        # drop stale hints: keys gone or no longer pending
        if self.plan:
            before = len(self.plan)
            self.plan = {
                k: a for k, a in self.plan.items()
                if (pts := state.tasks.get(k)) is not None and pts.state in _PENDING
            }
            self.hint_drops["stale-dropped"] += before - len(self.plan)
        # plan only runnable pending tasks whose dependencies are inside
        # the batch (rootish ones too: the partitioner co-assigns a tile's
        # sources with the tile)
        batch = []
        keyset = set(tasks)
        for ts in tasks.values():
            if ts.run_spec is None or ts.actor or ts.has_restrictions:
                continue
            if ts.state not in ("released", "waiting"):
                continue
            if all(dts.key in keyset for dts in ts.dependencies):
                batch.append(ts)
        if len(batch) < self.min_batch or len(batch) > self.max_batch:
            return 0
        if len(state.workers) < max(self.min_workers, 2):
            return 0
        # PRIORITY order is load-bearing: the partitioner's block init
        # chunks this axis, and priorities are depth-first graph order
        batch.sort(key=lambda ts: ts.priority or (0,))
        durations, out_bytes, known_frac = self._snapshot_nodes(state, batch)
        ratio = self.min_transfer_ratio
        if (
            ratio
            and known_frac >= 0.5
            and float(out_bytes.mean()) / state.bandwidth + state.transfer_latency
            < ratio * float(durations.mean())
        ):
            # transfers are noise next to compute (only trusted when most
            # durations are measured, not the unknown-task default)
            return 0
        snapshot = self._snapshot(state, batch, durations, out_bytes)
        state.trace.emit("kernel", "placement-plan", stimulus_id, n=len(batch))

        try:
            loop = asyncio.get_running_loop() if not self.sync else None
        except RuntimeError:
            loop = None
        engine: dict = {}
        if loop is None:
            try:
                state.wall.push("kernel.dispatch", stimulus_id)
                try:
                    plan = self._plan_from_arrays(*snapshot, stats=engine)
                finally:
                    state.wall.pop()
            except Exception:
                logger.exception("device planning failed; disabling co-processor")
                self.enabled = False
                return 0
            if engine.get("shards"):
                state.observe_engine_shards(engine["shards"])
            self.plan.update(plan)
            self.plan_stim = stimulus_id
            self.plans_computed += 1
            return len(plan)

        if self._executor is None:
            self._executor = _DaemonExecutor("torch-placement")
        self.plans_inflight += 1
        wall = state.wall

        def _plan_job(*args):
            # the async plan bills its wall to the planner thread's stack
            wall.push("kernel.dispatch", stimulus_id)
            try:
                return self._plan_from_arrays(*args, stats=engine)
            finally:
                wall.pop()

        fut = self._executor.submit(_plan_job, *snapshot)

        def _done(f):
            try:
                plan = f.result()
            except BaseException as exc:
                if isinstance(exc, (KeyboardInterrupt, SystemExit)):
                    raise
                plan = None
                # a future cancelled by close() is a clean shutdown
                if not f.cancelled():
                    logger.exception("device planning failed; disabling co-processor")
                    self.enabled = False
            try:
                loop.call_soon_threadsafe(self._merge, plan, state, stimulus_id,
                                          engine.get("shards"))
            except RuntimeError:
                # loop closed before the plan landed
                self.plans_inflight -= 1

        fut.add_done_callback(_done)
        return 0

    def planner_ident(self) -> int | None:
        """Thread ident of the planner thread (None before the first
        async plan); the control-plane profiler samples it."""
        ex = self._executor
        return ex._thread.ident if ex is not None else None

    def close(self) -> None:
        """Release the planning thread (scheduler shutdown)."""
        self.enabled = False
        if self._executor is not None:
            self._executor.shutdown()
            self._executor = None

    def _merge(self, plan, state, stimulus_id: str = "", engine_shards=None) -> None:
        """Land an async plan on the loop thread, keeping only hints for
        tasks still pending."""
        self.plans_inflight -= 1
        if engine_shards:
            state.observe_engine_shards(engine_shards)
        if not plan:
            return
        live = {
            k: v for k, v in plan.items()
            if (ts := state.tasks.get(k)) is not None and ts.state in _PENDING
        }
        self.hint_drops["landed-late"] += len(plan) - len(live)
        if live:
            self.plan.update(live)
            self.plan_stim = stimulus_id
            self.plans_computed += 1
            logger.debug("planned %d tasks on device (%d already placed)",
                         len(live), len(plan) - len(live))

    @staticmethod
    def _snapshot_nodes(state, batch: list):
        """Per-task cost arrays + the fraction of MEASURED durations."""
        n = len(batch)
        durations = np.empty(n, np.float32)
        out_bytes = np.empty(n, np.float32)
        known = 0
        for i, ts in enumerate(batch):
            prefix = ts.prefix
            if prefix is not None and prefix.duration_average >= 0:
                known += 1
            durations[i] = state.get_task_duration(ts)
            nbytes = ts.nbytes
            if nbytes < 0 and prefix is not None and prefix.nbytes_total:
                counts = sum(prefix.state_counts.values()) or 1
                nbytes = prefix.nbytes_total / counts
            out_bytes[i] = nbytes if nbytes and nbytes > 0 else _DEFAULT_NBYTES
        return durations, out_bytes, known / max(n, 1)

    def _snapshot(self, state, batch: list, durations, out_bytes):
        """Synchronous array snapshot of the batch and the fleet (the task
        graph must not be touched off the loop).  The fleet comes from the
        state's persistent mirror when it has one (copied: the planner
        reads it while the loop mutates the live buffers).  With an engine
        mesh and a :class:`TorchMirror`, the mirror's workers-axis view is
        taken here, on the loop: its blocks never change after they are
        handed out."""
        index = {ts.key: i for i, ts in enumerate(batch)}
        keys = [ts.key for ts in batch]
        src: list[int] = []
        dst: list[int] = []
        for i, ts in enumerate(batch):
            for dts in ts.dependencies:
                j = index.get(dts.key)
                if j is not None:
                    src.append(j)
                    dst.append(i)
        mirror = state.mirror
        if mirror is not None:
            fv = mirror.fleet_view()
            nthreads = fv.nthreads.copy()
            occupancy = fv.occupancy.copy()
            running = fv.running.copy()
            addrs = list(fv.addrs)
        else:
            workers = list(state.workers.values())
            nthreads = np.asarray([ws.nthreads for ws in workers], np.int32)
            occupancy = np.asarray([ws.occupancy for ws in workers], np.float32)
            running = np.asarray([ws in state.running for ws in workers], bool)
            addrs = [ws.address for ws in workers]
        mesh = self._mesh
        fleet_dev = None
        if mesh is not None and isinstance(mirror, TorchMirror):
            fleet_dev = mirror.sharded_device_view(mesh)
        return (
            keys, durations, out_bytes,
            np.asarray(src, np.int32), np.asarray(dst, np.int32),
            nthreads, occupancy, running, addrs, state.bandwidth,
            state.transfer_latency, mesh, fleet_dev,
        )

    def _plan_from_arrays(self, keys, durations, out_bytes, src, dst, nthreads,
                          occupancy, running, addrs, bandwidth,
                          transfer_latency=0.0, mesh=None, fleet_dev=None,
                          stats: dict | None = None) -> dict:
        """Plan on pure arrays (safe off the loop) and return the hints.

        The partitioner while ``_bucket(T)`` times the lanes fits
        ``DENSE_LIMIT``: a worker appears once per thread as a lane (a
        2-thread worker should receive twice the work), and each task's
        lane folds back to its worker as an absolute home.  Otherwise the
        leveled engine (``scheduler/plan.py``), through the sharded engine
        when there is a mesh (``mesh``, else the placement's own), fed by
        ``fleet_dev`` when given; ``stats`` then receives the engine's
        ``n_shards``, ``runs`` and per-shard ``shards`` rows."""
        if mesh is None:
            mesh = self._mesh
        run_idx = np.flatnonzero(running)
        lanes: list[int] = []
        for wi in run_idx:
            lanes.extend([int(wi)] * max(int(nthreads[wi]), 1))
        on_card = (
            torch.cuda.device(self.device) if self.device.type == "cuda"
            else contextlib.nullcontext()
        )
        engine = self.partitioner
        if engine is None:
            engine = _check_partitioner(config.get("scheduler.jax.partitioner"))
        with on_card:
            if (
                engine != "off"
                and len(run_idx) >= 2
                and part._bucket(len(keys)) * len(lanes) <= part.DENSE_LIMIT
            ):
                weights = (out_bytes[src] / bandwidth + transfer_latency).astype(np.float32)
                if engine == "numpy":
                    labels = part.partition_numpy(durations, weights, src, dst, len(lanes))
                else:
                    labels = part.partition_padded(durations, weights, src, dst, len(lanes),
                                                   device=self.device)
                return planning.hints_from_partition(keys, labels, lanes, addrs)
            return planning.plan_from_arrays(
                keys, durations, out_bytes, src, dst, nthreads, occupancy, running,
                addrs, bandwidth, transfer_latency, device=self.device, mesh=mesh,
                fleet_dev=fleet_dev, stats=stats,
            )

    def __repr__(self) -> str:
        return (
            f"<TorchPlacement plans={self.plans_computed} "
            f"hits={self.plan_hits} misses={self.plan_misses} "
            f"pending={len(self.plan)} enabled={self.enabled}>"
        )
