"""Work stealing: rebalance assigned-but-unstarted tasks (reference stealing.py).

Every 100 ms, ``balance()`` moves queued work from saturated workers
("victims") to idle ones ("thieves") when the move pays for itself:
``occ_thief + cost <= occ_victim - cost/2`` (reference stealing.py:462-465).
Tasks are bucketed into 15 cost levels by log2(transfer_time /
compute_time) so cheap-to-move work is considered first.  Moves use an
async confirm protocol with the victim worker — the task may already be
executing there — fenced by stimulus ids (reference stealing.py:279,333).

The inner (victim, level, thief) selection is a pure function over
occupancy/cost arrays; ``distributed_tpu_torch.ops.stealing`` provides the
batched device variant (K Jacobi rounds of rank-matched victim/thief
pairing under the same steal criterion), used when the JAX co-processor
is enabled, the fleet is at least ``scheduler.jax.min-workers``, and the
cycle has enough stealable tasks to amortize a device dispatch.  Either
path feeds the same async confirm protocol.

The port's copy of ``distributed_tpu/scheduler/stealing.py``, in two parts.

1. The ``WorkStealing`` extension (``:61-935``), line for line but for its
   device seams.  The gate reads the port's ``scheduler.jax.*``
   configuration (``gate.config_gate``); a cycle the gate sends to the
   device runs :meth:`StealingPath.balance_device` on ``state.device``, so
   K7 runs with no install step.  A failure there is counted on the path
   and raised (the reference logs it and steals in python).
2. The device path, :class:`StealingPath`: the port's copies of the
   reference's ``_balance_cycle``, ``_balance_device`` and
   ``_device_plan_landed`` (``:488-579,595-846``), which
   :func:`install_stealing` also binds onto a reference ``WorkStealing``
   *instance* (the port cannot subclass the reference's class; that
   extension's own ``balance``, ``_apply_device_plan`` and ``_steal_pays``
   stay: they hold no JAX).  What differs from the reference:

   - an installed path's gate is :class:`~distributed_tpu_torch.scheduler.gate.DevicePath`'s
     explicit parameters rather than the reference's configuration;
   - the fleet comes from the :class:`~distributed_tpu_torch.scheduler.mirror.TorchMirror`'s
     device view (the state's mirror is adopted when it is another kind);
     the in-flight overlay is added out of place (``index_add``), so the
     cached occupancy never absorbs it;
   - the plan (``ops/stealing.py::plan_steals``, kernel K7 on the card)
     runs on the port's daemon executor, after waiting on the mirror's
     upload event, so upload and launch are ordered whatever thread or
     stream each runs on; with no event loop (the simulator) it runs inline;
   - no ``except`` swallows a failure of the device path: it is counted in
     ``failures``, kept in ``errors`` and raised, out of ``balance()`` (or,
     for a plan computed off the loop, out of the callback that lands it).
"""

from __future__ import annotations

import asyncio
import functools
import logging
from collections import defaultdict, deque
from math import log2
from typing import TYPE_CHECKING, Any

import numpy as np
import torch

from distributed_tpu_torch import config
from distributed_tpu_torch._device import resolve_device
from distributed_tpu_torch.exceptions import CommClosedError
from distributed_tpu_torch.graph.spec import Key
from distributed_tpu_torch.ops import stealing as ops_stealing
from distributed_tpu_torch.ops.stealing import _RANK_BITS
from distributed_tpu_torch.rpc.core import PeriodicCallback
from distributed_tpu_torch.scheduler.gate import (
    DevicePath,
    config_gate,
    device_dispatch_worthwhile,
)
from distributed_tpu_torch.scheduler.mirror import DEVICE_FIELDS, TorchMirror
from distributed_tpu_torch.scheduler.torch_placement import _DaemonExecutor
from distributed_tpu_torch.utils import OrderedSet
from distributed_tpu_torch.utils.misc import seq_name, time

if TYPE_CHECKING:
    from distributed_tpu_torch.scheduler.state import TaskState, WorkerState

logger = logging.getLogger("distributed_tpu_torch.stealing")

# 15 steal levels; level i covers cost ratios around 2**(i-7)
# (reference stealing.py:70: fast tasks in low levels move first)
N_LEVELS = 15
LATENCY = 0.1  # assumed steal round-trip (reference stealing.py:33-37)


class InFlightInfo:
    __slots__ = ("victim", "thief", "victim_duration", "thief_duration", "stimulus_id")

    def __init__(self, victim, thief, victim_duration, thief_duration, stimulus_id):
        self.victim = victim
        self.thief = thief
        self.victim_duration = victim_duration
        self.thief_duration = thief_duration
        self.stimulus_id = stimulus_id


class WorkStealing:
    """Scheduler extension (reference stealing.py:57)."""

    def __init__(self, scheduler: "Scheduler"):
        self.scheduler = scheduler
        self.state = scheduler.state
        # stealable[worker_address][level] -> set of TaskStates
        self.stealable: dict[str, list[OrderedSet]] = {}
        self.key_stealable: dict[Key, tuple[str, int]] = {}
        # in-flight steal requests awaiting worker confirmation
        self.in_flight: dict[Key, InFlightInfo] = {}
        # extra occupancy accounted to workers for unconfirmed moves
        self.in_flight_occupancy: defaultdict[Any, float] = defaultdict(float)
        self.in_flight_tasks: defaultdict[Any, int] = defaultdict(int)
        self.metrics: dict[str, dict] = {
            "request_count_total": defaultdict(int),
            "request_cost_total": defaultdict(float),
        }
        self.count = 0
        self.log: deque = deque(maxlen=100_000)
        self._in_flight_event = asyncio.Event()
        self._in_flight_event.set()
        self.enabled = bool(config.get("scheduler.work-stealing"))
        self.speculative = bool(
            config.get("scheduler.work-stealing-speculative")
        )
        # event-driven balance: a kick is pending between the triggering
        # transition and its (debounced) tick
        self._kick_pending = False
        self._last_balance = 0.0
        # injectable seams (ROADMAP item 1 simulator): the sans-io sim
        # re-points ``clock`` at its VirtualClock (the 0.05 s python
        # cycle bound must never read the wall clock there — a wall
        # break mid-cycle would make two same-seed runs diverge) and
        # ``seq`` at a per-run deterministic id mint (seq_name is a
        # process-global counter, so ids would differ between runs)
        self.clock = time
        self.seq = seq_name
        self._rr = 0  # round-robin cursor for dep-free thief choice
        # off-loop device-plan pipeline (see _balance_device)
        self._device_plan_inflight = False
        self._device_executor: Any | None = None
        self._device_path: StealingPath | None = None

        for ws in self.state.workers.values():
            self.add_worker_state(ws)

        self.state.plugins["stealing"] = self
        scheduler.stream_handlers["steal-response"] = self.move_task_confirm
        interval = config.parse_timedelta(
            config.get("scheduler.work-stealing-interval")
        )
        self._pc = PeriodicCallback(self.balance, interval)
        if config.get("scheduler.work-stealing"):
            scheduler.periodic_callbacks["stealing"] = self._pc
            if scheduler.status.name == "running":
                self._pc.start()

    async def close(self) -> None:
        self._pc.stop()
        if self._device_executor is not None:
            self._device_executor.shutdown(wait=False, cancel_futures=True)
            self._device_executor = None

    # -------------------------------------------------------- plugin hooks

    def add_worker_state(self, ws: "WorkerState") -> None:
        # OrderedSet: the balance cycle steals a level's tasks in
        # iteration order, and restart recovery rebuilds these from the
        # snapshot's key_stealable order (scheduler/durability.py) — a
        # hash-ordered set cannot reproduce the pre-crash scan order
        self.stealable[ws.address] = [OrderedSet() for _ in range(N_LEVELS)]

    def add_worker(self, scheduler: Any, address: str) -> None:
        ws = self.state.workers.get(address)
        if ws is not None and address not in self.stealable:
            self.add_worker_state(ws)

    def remove_worker(self, scheduler: Any, address: str) -> None:
        self.stealable.pop(address, None)
        # drop the departed worker's overlay + metric rows NOW: with
        # steals continuously in flight the bulk clear in
        # _revert_in_flight never runs, and the defaultdicts otherwise
        # retain one row per ever-removed WorkerState — a dead row
        # could even scatter onto a reused mirror slot (census-found,
        # tests/test_census.py)
        for d in (self.in_flight_occupancy, self.in_flight_tasks):
            for ws in [w for w in d if w.address == address]:
                del d[ws]
        for m in self.metrics.values():
            m.pop(address, None)

    # Tape-safe plugin contract (scheduler/native_engine.py): the
    # native engine's applier replays ``transition`` per tape row in
    # exact stream order with task/scheduler state current as of that
    # row.  This hook qualifies because it reads only its arguments,
    # row-current task state and stealing-private structures — it must
    # never read WorkerState.occupancy (native floods sync occupancy at
    # segment end, not per row).  Any plugin WITHOUT this marker forces
    # the whole flood onto the pure-python oracle.
    tape_safe = True

    def transition(self, key: Key, start: str, finish: str, *args: Any,
                   **kwargs: Any) -> None:
        """Track stealability as tasks enter/leave processing."""
        if finish == "processing":
            ts = self.state.tasks[key]
            self.put_key_in_stealable(ts)
            self._maybe_kick()
        elif start == "processing":
            ts = self.state.tasks.get(key)
            if ts is not None:
                self.remove_key_from_stealable(ts)
            info = self.in_flight.pop(key, None)
            if info is not None:
                self._revert_in_flight(info)

    # ----------------------------------------------------- stealable index

    def steal_time_ratio(self, ts: "TaskState") -> tuple[float | None, int | None]:
        """(cost, level); cost_multiplier None = never steal
        (reference stealing.py:241)."""
        if not ts.dependencies:
            return 0, 0
        # restrictions are NOT filtered here: _get_thief restricts the
        # candidate set (with the loose-restrictions fallback), matching
        # reference stealing.py:530-541
        if ts.actor:
            return None, None
        compute_time = self.state.get_task_duration(ts)
        if compute_time <= 0:
            return None, None
        nbytes = sum(dts.get_nbytes() for dts in ts.dependencies)
        transfer_time = nbytes / self.state.bandwidth + LATENCY
        cost = transfer_time / compute_time
        level = int(min(N_LEVELS - 1, max(0, log2(cost + 1e-9) + 7)))
        return cost, level

    def put_key_in_stealable(self, ts: "TaskState") -> None:
        if ts.processing_on is None:
            return
        if ts.homed:
            # placed on its plan-assigned home: stealing a co-assigned
            # tile apart undoes the partition plan (measured: with deep
            # home stacks stealable, peer fetches tripled back to the
            # no-plan level).  Drift is shed by the placement resolve's
            # backlog-outlier check, not by the balancer.
            return
        cost, level = self.steal_time_ratio(ts)
        if cost is None:
            return
        addr = ts.processing_on.address
        levels = self.stealable.get(addr)
        if levels is None:
            return
        levels[level].add(ts)
        self.key_stealable[ts.key] = (addr, level)

    def remove_key_from_stealable(self, ts: "TaskState") -> None:
        loc = self.key_stealable.pop(ts.key, None)
        if loc is None:
            return
        addr, level = loc
        levels = self.stealable.get(addr)
        if levels is not None:
            levels[level].discard(ts)

    # ------------------------------------------------------- move protocol

    def _revert_in_flight(self, info: "InFlightInfo") -> None:
        """Close one confirm window's occupancy/task-count overlays —
        the ONE revert shared by the transition hook (task left
        processing mid-steal) and move_task_confirm.  Overlay rows for
        workers that were removed while the window was open are NOT
        recreated (the defaultdict write would resurrect a dead
        WorkerState's row forever), integer task counts delete at zero,
        and the bulk clear still runs whenever the last window closes
        (float overlay drift never outlives an idle balancer)."""
        occ = self.in_flight_occupancy
        counts = self.in_flight_tasks
        workers = self.state.workers
        thief, victim = info.thief, info.victim
        if thief in occ or workers.get(thief.address) is thief:
            occ[thief] -= info.thief_duration
        if victim in occ or workers.get(victim.address) is victim:
            occ[victim] += info.victim_duration
        left = counts.get(victim)
        if left is not None:
            if left <= 1:
                del counts[victim]
            else:
                counts[victim] = left - 1
        if not self.in_flight:
            occ.clear()
            counts.clear()
            self._in_flight_event.set()

    def seed_in_flight(self, ts: "TaskState", victim: "WorkerState",
                       thief: "WorkerState", victim_duration: float,
                       thief_duration: float, stimulus_id: str) -> None:
        """Open one confirm window: the ``in_flight`` entry plus its
        occupancy/task-count overlays.  The ONE copy of this
        bookkeeping, shared by the live move (``move_task_request``),
        the snapshot restore (``durability.restore_stealing``), and the
        journal replay (``flight_recorder``) — a change landing in only
        one copy diverges a restored scheduler's next balance cycle
        from the unbounced twin."""
        self.in_flight[ts.key] = InFlightInfo(
            victim, thief, victim_duration, thief_duration, stimulus_id
        )
        self.in_flight_occupancy[victim] -= victim_duration
        self.in_flight_occupancy[thief] += thief_duration
        self.in_flight_tasks[victim] += 1
        self._in_flight_event.clear()

    def move_task_request(self, ts: "TaskState", victim: "WorkerState",
                          thief: "WorkerState") -> None:
        """Ask the victim to relinquish ts (reference stealing.py:279)."""
        key = ts.key
        if key in self.in_flight:
            return
        stimulus_id = self.seq("steal")
        victim_duration = victim.processing.get(ts, 0.0)
        comm_cost = self.state.get_comm_cost(ts, thief)
        # shadow divergence monitor (read-only): this steal was priced
        # with the constant model — record the measured twin under the
        # move's stimulus id (telemetry.py; docs/observability.md)
        self.state.shadow_comm_cost(ts, thief, comm_cost, "steal",
                                    stimulus_id)
        compute = self.state.get_task_duration(ts)
        thief_duration = compute + comm_cost
        if self.state.ledger.enabled:
            # decision ledger (ledger.py): the steal DECISION is priced
            # here; this row supersedes the victim placement's open row.
            # On confirm the re-placement files the definitive "steal"
            # row (superseding this one in turn); a rejection joins it
            # as "rejected", and a victim finishing first joins it as
            # "overtaken" — steal regret never absorbs a realization
            # from a worker the kernel didn't price.
            self.state.ledger_file_decision(
                ts, thief, stimulus_id, "steal", compute, comm_cost
            )
        self.remove_key_from_stealable(ts)
        if self.state.trace.journal_enabled:
            # the confirm window is cross-payload scheduler truth: a
            # durable tail spanning an unanswered steal-request must
            # rebuild this in_flight entry or the victim's eventual
            # steal-response finds nothing and the move is dropped
            # (scheduler/durability.py; replayed by flight_recorder)
            self.state.trace.record(
                "steal-request",
                {"key": key, "victim": victim.address,
                 "thief": thief.address, "vd": repr(victim_duration),
                 "td": repr(thief_duration)},
                stimulus_id,
            )
        self.seed_in_flight(
            ts, victim, thief, victim_duration, thief_duration, stimulus_id
        )
        try:
            self.scheduler.send_all({}, {victim.address: [{
                "op": "steal-request", "key": key, "stimulus_id": stimulus_id,
            }]})
        except CommClosedError:
            self.in_flight.pop(key, None)

    def move_task_speculative(self, ts: "TaskState", victim: "WorkerState",
                              thief: "WorkerState") -> None:
        """Move WITHOUT the confirm round trip: free the key on the
        victim and re-place on the thief in one step.

        Only safe-and-profitable for tasks deep in a big victim backlog:
        the victim MIGHT already be executing the task (we cannot know
        without asking — that is what the confirm protocol serializes),
        but a wrong guess only wastes that one execution: free-keys
        cancels it victim-side, a stale completion report is fenced by
        ``processing_on``, and the thief's run is authoritative.  The
        reference always pays the round trip (reference
        stealing.py:279); on an imbalanced burst the confirm wait was
        ~20% of the whole rebalance wall."""
        key = ts.key
        if key in self.in_flight:
            return
        if self.state.workers.get(thief.address) is not thief or (
            thief not in self.state.running
        ):
            # dead thief: leave the task in stealable for the next cycle
            return
        stimulus_id = self.seq("steal-spec")
        # same shadow hop as the confirm path: the criterion priced this
        # move with the constant model just before calling here
        # (constant=None: recomputed only behind the sampling gate)
        self.state.shadow_comm_cost(ts, thief, None, "steal", stimulus_id)
        self.remove_key_from_stealable(ts)
        # the journaled engine twin performs the move (ledger kind
        # "steal-spec": the re-placement row supersedes the victim
        # placement's open row in one step — no confirm leg)
        _cm, ws_msgs = self.state.stimulus_steal_move(
            key, victim.address, thief.address, stimulus_id,
            kind="steal-spec",
        )
        msgs = {victim.address: [{
            "op": "free-keys", "keys": [key], "stimulus_id": stimulus_id,
        }]}
        for addr, lst in ws_msgs.items():
            msgs.setdefault(addr, []).extend(lst)
        self.count += 1
        self.log.append(("speculative", key, victim.address, thief.address))
        self.metrics["request_count_total"][victim.address] += 1
        try:
            self.scheduler.send_all({}, msgs)
        except CommClosedError:
            pass

    async def move_task_confirm(self, key: Key = "", state: str | None = None,
                                stimulus_id: str = "", worker: str = "",
                                **kwargs: Any) -> None:
        """The victim answered (reference stealing.py:333)."""
        info = self.in_flight.pop(key, None)
        if info is None:
            return
        if self.state.trace.journal_enabled:
            # the CLOSE of the confirm window is cross-payload truth
            # too: without this record a tail spanning request+answer
            # replays the in_flight entry back to life (occupancy
            # overlays included) and the bounced scheduler's next
            # balance cycle diverges from the unbounced twin.  matched
            # mirrors the stimulus fence for the MOVE only: matched or
            # not, a consumed window always reverts its overlays (the
            # live semantics below; replay_stimulus_trace calls the
            # same _revert_in_flight).
            self.state.trace.record(
                "steal-confirm",
                {"key": key, "matched": info.stimulus_id == stimulus_id},
                stimulus_id,
            )
        if info.stimulus_id != stimulus_id:
            # a mismatched (stale/forged) answer still CONSUMED the
            # window: revert the overlays too, or the skew — and the
            # dead defaultdict rows carrying it — outlive the steal
            # forever (found by the poison-flood census gate)
            self._revert_in_flight(info)
            return
        victim, thief = info.victim, info.thief
        self._revert_in_flight(info)

        ts = self.state.tasks.get(key)
        if ts is None or ts.state != "processing" or ts.processing_on is not victim:
            # the task finished / was released / moved meanwhile
            return
        if self.state.workers.get(victim.address) is not victim:
            return
        if state in ("ready", "waiting"):
            # victim gave it up: reassign to thief through the journaled
            # engine twin (stimulus_steal_move) — the definitive "steal"
            # ledger row supersedes the request row filed at
            # move_task_request and joins at memory with the regret.  A
            # dead thief degrades to reschedule-from-scratch inside the
            # twin; either way the move replays from the journal tail.
            thief_alive = (
                self.state.workers.get(thief.address) is thief
                and thief in self.state.running
            )
            cm, wm = self.state.stimulus_steal_move(
                key, victim.address, thief.address, stimulus_id,
                kind="steal",
            )
            if thief_alive:
                self.count += 1
                self.log.append(
                    ("confirm", key, victim.address, thief.address)
                )
                self.metrics["request_count_total"][victim.address] += 1
            self.scheduler.send_all(cm, wm)
        else:
            # already executing (or gone): leave it
            if ts.ledger_row >= 0:
                self.state.ledger.join_row(ts.ledger_row, "rejected")
                ts.ledger_row = -1
            self.log.append(("reject", key, state, victim.address))

    # ------------------------------------------------------------ balance

    # below this many stealable tasks a device dispatch costs more than
    # the python scan it replaces
    DEVICE_MIN_TASKS = 64

    def _maybe_kick(self) -> None:
        """Event-driven stealing: a task just landed on a worker while
        others sit idle — schedule a balance tick shortly instead of
        waiting out the periodic interval.  The reference relies on the
        100 ms cycle alone (reference stealing.py:402), which makes the
        first-cycle latency dominate short imbalanced bursts; the 5 ms
        debounce batches a whole submit wave into one tick."""
        if self._kick_pending or not self.enabled or not self.state.idle:
            return
        self._kick_pending = True
        # plain TimerHandle, not a background Task: kicks fire on the
        # per-task hot path, and a Task + sleep + done-callback per kick
        # is measurable loop load at thousands of tasks/s
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            self._kick_pending = False
            return
        loop.call_later(0.005, self._kick_tick)

    def _kick_tick(self) -> None:
        self._kick_pending = False
        if (
            self.enabled
            and not self.scheduler._ongoing_background_tasks.closed
            and self.clock() - self._last_balance >= 0.02
        ):
            self.balance()

    def balance(self) -> None:
        """One stealing cycle (reference stealing.py:402)."""
        rr0 = self._rr
        self._balance_cycle()
        if self._rr != rr0 and self.state.trace.journal_enabled:
            # the dep-free round-robin cursor advanced this cycle — and
            # not every advance pairs with a journaled steal-request (a
            # candidate can fail _steal_pays after the rotation).  The
            # cursor picks future thieves, so a durable tail must pin it
            # or a restored scheduler's next balance diverges from the
            # unbounced twin (scheduler/durability.py).
            self.state.trace.record(
                "steal-rr", {"rr": self._rr}, self.seq("steal-rr")
            )

    def _balance_cycle(self) -> None:
        self._last_balance = self.clock()
        s = self.state
        if not s.idle or len(s.workers) < 2:
            return
        idle_workers = [ws for ws in s.idle.values() if ws in s.running]
        if not idle_workers:
            return
        n_stealable = sum(
            len(t) for levels in self.stealable.values() for t in levels
        )
        if not n_stealable:
            # nothing to move (e.g. every queued task is homed/pinned —
            # the shuffle regime): skip both engines outright
            return
        if self._device_plan_inflight:
            # a device plan is being computed off-loop for a snapshot a
            # few ms old; applying python steals on top would double-move
            return
        if device_dispatch_worthwhile(
            len(s.workers),
            n_stealable,
            self.DEVICE_MIN_TASKS,
            periodic=True,
            **config_gate(),
        ):
            path = self.device_path()
            path.cycles_device += 1
            try:
                self._balance_device(idle_workers)
            except Exception as exc:
                path.fail(exc)
                raise
            return
        # flight-recorder kernel hop: one event per host-path cycle
        # (the device path stamps its own in _balance_device)
        s.trace.emit("kernel", "steal-cycle", "", n=n_stealable, dest="host")
        if s.saturated:
            victims = list(s.saturated)
        else:
            victims = sorted(
                (ws for ws in s.workers.values()
                 if ws.processing and ws not in s.idle.values()),
                key=lambda ws: ws.occupancy / max(ws.nthreads, 1),
                reverse=True,
            )[:10]
        start = self.clock()
        for victim in victims:
            levels = self.stealable.get(victim.address)
            if levels is None:
                continue
            for level, tasks in enumerate(levels):
                if not tasks:
                    continue
                for ts in list(tasks):
                    if not idle_workers:
                        return
                    if ts.key in self.in_flight or ts.processing_on is not victim:
                        tasks.discard(ts)
                        continue
                    thief = self._get_thief(ts, idle_workers)
                    if thief is None:
                        continue
                    occ_thief = self._combined_occupancy(thief)
                    occ_victim = self._combined_occupancy(victim)
                    comm_cost_thief = s.get_comm_cost(ts, thief)
                    compute = s.get_task_duration(ts)
                    if (
                        occ_thief / max(thief.nthreads, 1)
                        + comm_cost_thief + compute
                        <= occ_victim / max(victim.nthreads, 1) - compute / 2
                    ):
                        if (
                            self.speculative
                            and len(victim.processing) >= 4 * victim.nthreads
                            and not ts.actor
                            and not ts.resource_restrictions
                        ):
                            # deep pile: the odds this particular task is
                            # already executing are < nthreads/len — skip
                            # the confirm round trip (wrong guesses waste
                            # one execution, never correctness)
                            self.move_task_speculative(ts, victim, thief)
                        else:
                            self.move_task_request(ts, victim, thief)
                        occ_thief = self._combined_occupancy(thief)
                        if occ_thief / max(thief.nthreads, 1) > LATENCY:
                            idle_workers = [
                                w for w in idle_workers if w is not thief
                            ]
            if self.clock() - start > 0.05:  # bound cycle time like the reference
                break

    # bounds for one device cycle, mirroring the python path's top-10
    # victims + 0.05 s cycle cap (reference stealing.py:402): the SoA
    # snapshot python-loop runs on the event loop and must stay O(bounded)
    DEVICE_MAX_VICTIMS = 32
    DEVICE_MAX_TASKS = 8192

    # bounds on the thief-resident byte scan (event-loop work): skip
    # very wide tasks (the missing remainder dominates the price
    # anyway), and skip deps replicated past the holder cap (per-dep
    # scans are memoized per cycle, so total cost is
    # O(distinct deps x capped holders) + O(tasks x deps) combines)
    DEVICE_RESIDENT_SCAN_MAX_DEPS = 32
    DEVICE_RESIDENT_SCAN_MAX_HOLDERS = 16

    def _balance_device(self, idle_workers: list) -> None:
        """One balance cycle through the port's device path (K7 on the
        state's device, fed by the mirror's view; see
        :meth:`StealingPath.balance_device`)."""
        self.device_path().balance_device(self, idle_workers)

    def _device_plan_landed(self, fut, tasks: list, ws_of: list,
                            alt_thief: list) -> None:
        self.device_path().device_plan_landed(self, fut, tasks, ws_of, alt_thief)

    def device_path(self) -> "StealingPath":
        """This extension's device path, on the state's device, made at
        the first cycle the gate sends to the device."""
        if self._device_path is None:
            self._device_path = StealingPath(self.state.device, **config_gate())
        return self._device_path

    def _steal_pays(self, ts: "TaskState", victim: "WorkerState",
                    thief: "WorkerState") -> bool:
        """The python balance criterion against LIVE state with the TRUE
        per-thief comm cost (thief-resident dependencies subtracted) —
        the device kernel priced every candidate at its best-case
        cost, so each accepted move re-earns its place here."""
        s = self.state
        compute = s.get_task_duration(ts)
        return (
            self._combined_occupancy(thief) / max(thief.nthreads, 1)
            + s.get_comm_cost(ts, thief) + compute
            <= self._combined_occupancy(victim) / max(victim.nthreads, 1)
            - compute / 2
        )

    def _apply_device_plan(self, thief_of, tasks: list, ws_of: list,
                           alt_thief: list | None = None) -> None:
        s = self.state
        if alt_thief is None:
            alt_thief = [-1] * len(tasks)
        for ts, ti, ai in zip(tasks, thief_of, alt_thief):
            if ti < 0:
                continue
            thief = ws_of[int(ti)]
            victim = ts.processing_on
            if thief is None or victim is None or ts.key in self.in_flight:
                continue
            if ts.homed:
                # pinned home while the plan computed off-loop (shuffle
                # registration): stealing it now would move its input
                # partition off the very worker the pin protects
                continue
            valid = s.valid_workers(ts)

            def eligible(w) -> bool:
                if w is None or w is victim or w not in s.running:
                    return False
                return (
                    valid is None or w in valid or ts.loose_restrictions
                )

            if not eligible(thief):
                continue
            if not self._steal_pays(ts, victim, thief):
                # the rank-matched thief can't pay the true comm cost;
                # the thief the lower-bound price was computed FOR (the
                # idle holder of the most dependency bytes) may still
                alt = (
                    ws_of[int(ai)] if 0 <= int(ai) < len(ws_of) else None
                )
                if (
                    alt is None or alt is thief or not eligible(alt)
                    or not self._steal_pays(ts, victim, alt)
                ):
                    continue
                thief = alt
            self.move_task_request(ts, victim, thief)

    def _combined_occupancy(self, ws: "WorkerState") -> float:
        # .get, NOT the defaultdict read: a [] miss here materialized a
        # permanent 0.0 row per ever-priced worker (census-found — the
        # overlay must only ever hold rows opened by seed_in_flight)
        return ws.occupancy + self.in_flight_occupancy.get(ws, 0.0)

    def _get_thief(self, ts: "TaskState",
                   idle_workers: list) -> "WorkerState | None":
        valid = self.state.valid_workers(ts)
        candidates = idle_workers
        if valid is not None:
            restricted = [ws for ws in idle_workers if ws in valid]
            if restricted:
                candidates = restricted
            elif not ts.loose_restrictions:
                return None
        if not candidates:
            return None
        if not ts.dependencies:
            # dep-free tasks see every idle thief as equal (objective is
            # occupancy only): rotate instead of re-running the O(W) min
            # per task — same spread, none of the scan
            self._rr += 1
            return candidates[self._rr % len(candidates)]
        return min(
            candidates, key=lambda ws: self.state.worker_objective(ts, ws)
        )

    def story(self, *keys: Key) -> list:
        return [t for t in self.log if any(k in t for k in keys)]


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
