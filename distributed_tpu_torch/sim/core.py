"""Deterministic sans-io cluster simulator (ROADMAP item 1).

``ClusterSim`` drives thousands of **real** ``WorkerState`` machines
plus one **real** scheduler engine (``SchedulerState`` with the batched
``transitions_batch`` plane, the real ``WorkStealing`` and
``ActiveMemoryManagerExtension``) in a single process off a
``VirtualClock`` and an ``EventHeap`` — **no sockets, no event loop,
no threads**.  The message bus carries the same op-dict payloads the
wire carries: compute-task / free-keys / steal-request / ... toward
workers, task-finished / add-keys / missing-data / steal-response /
... toward the scheduler, with consecutive same-op runs folded into
the ``stimulus_*_batch`` arms exactly as ``rpc.core.handle_stream``
folds live floods.

Determinism contract: two ``ClusterSim`` runs built with the same
parameters and seed — in the same process (set iteration order depends
on ``PYTHONHASHSEED``, which is fixed per process) — pop the identical
event sequence, drive the identical transition streams, and produce
bit-identical digests and virtual makespans.  Everything that would
break this is seamed out: stimulus ids are minted per-run
(``ClusterSim.seq``), the stealing cycle bound reads the virtual clock,
and no code path consulted during a run reads the wall clock.

The virtual-time makespan a run reports is therefore a property of the
workload + link profile + policies alone, immune to the host box's
documented 2x wall-clock drift (PERF.md) — the perf-gate property the
``sim`` bench-smoke config asserts on every PR.

The port's copy of ``distributed_tpu/sim/core.py``, line for line but for
these seams:

- ``ClusterSim(device=...)``: with ``use_device_kernels=True`` the
  scheduler state's fleet mirror (K6) and the steal and AMM device paths
  (K7, K8) run on that device (``None`` means CUDA and raises without a
  card; ``"cpu"`` runs their plain versions).  A placement is attached as
  in the reference, through ``sim.state.placement``;
- what reaches a module the port does not have yet raises
  ``NotImplementedError`` naming its ROADMAP entry: ``enable_durability``
  and ``bounce_scheduler`` (``scheduler/durability.py``), the stimulus
  journal (``journal_start``; its replay is
  ``diagnostics/flight_recorder.py``) and ``critical_path``
  (``diagnostics/critical_path.py``).
"""

from __future__ import annotations

import hashlib
import logging
import random
from collections import defaultdict
from typing import Any, Callable, Iterable

from distributed_tpu_torch import config
from distributed_tpu_torch.protocol.serialize import unwrap
from distributed_tpu_torch.scheduler.state import SchedulerState
from distributed_tpu_torch.sim.clock import VirtualClock
from distributed_tpu_torch.sim.events import EventHeap
from distributed_tpu_torch.sim.links import SCHEDULER, LinkProfile
from distributed_tpu_torch.worker.state_machine import (
    AcquireReplicasEvent,
    ComputeTaskEvent,
    Execute,
    ExecuteFailureEvent,
    ExecuteSuccessEvent,
    FindMissingEvent,
    FreeKeysEvent,
    GatherDep,
    GatherDepNetworkFailureEvent,
    GatherDepSuccessEvent,
    Instruction,
    PauseEvent,
    RefreshWhoHasEvent,
    RemoveReplicasEvent,
    RetryBusyWorkerEvent,
    RetryBusyWorkerLater,
    SendMessageToScheduler,
    StateMachineEvent,
    StealRequestEvent,
    UnpauseEvent,
    UpdateDataEvent,
    WorkerState,
)

logger = logging.getLogger("distributed_tpu_torch.sim")

#: default per-task profile when a trace supplies none
DEFAULT_DURATION = 0.005
DEFAULT_NBYTES = 1024

#: the live worker server's busy-peer retry delay (worker/server.py)
RETRY_BUSY_DELAY = 0.15


def _not_in_port(what: str, entry: str) -> None:
    raise NotImplementedError(
        f"{what} is not in the port yet (ROADMAP queue 1: {entry})"
    )


class _SimRunSpec:
    """Tiny shared run-spec sentinel: the scheduler requires a non-None
    ``run_spec`` to schedule a task, and the simulated worker never
    executes user code — ONE instance serves every simulated task."""

    __slots__ = ()

    def __repr__(self) -> str:
        return "<sim-run-spec>"


SIM_SPEC = _SimRunSpec()


class _Status:
    name = "init"  # extensions must not auto-start periodic callbacks


class SimSchedulerHost:
    """The minimal Scheduler-server surface the state-machine extensions
    (WorkStealing, ActiveMemoryManagerExtension) bind to, with
    ``send_all`` routed onto the virtual message bus instead of batched
    comms."""

    def __init__(self, sim: "ClusterSim", state: SchedulerState):
        self.sim = sim
        self.state = state
        self.stream_handlers: dict[str, Callable] = {}
        self.handlers: dict[str, Callable] = {}
        self.periodic_callbacks: dict = {}
        self.extensions: dict[str, Any] = {}
        self.status = _Status()

    def send_all(self, client_msgs: dict, worker_msgs: dict) -> None:
        self.sim._route_scheduler_output(client_msgs, worker_msgs)


class SimWorker:
    """One virtual worker: a real ``WorkerState`` plus the sim's stand-in
    for the networked shell — op dicts in, instructions out, every
    instruction resolved against the virtual clock and link profile."""

    __slots__ = ("sim", "address", "state", "alive", "slots",
                 "duration_scale", "n_executed")

    def __init__(self, sim: "ClusterSim", address: str, state: WorkerState):
        self.sim = sim
        self.address = address
        self.state = state
        self.alive = True
        self.slots = [0.0] * max(state.nthreads, 1)  # thread free times
        self.duration_scale = 1.0  # straggler chaos multiplies this
        self.n_executed = 0

    # -------------------------------------------------------- op -> event

    def _to_events(self, msgs: list[dict]) -> list[StateMachineEvent]:
        """Mirror of the worker server's ``_stream_*`` conversions: one
        scheduler payload becomes ONE ``handle_stimulus`` batch so dep
        fetches aggregate exactly as live payload-boundary batching
        does."""
        events: list[StateMachineEvent] = []
        for m in msgs:
            m = dict(m)
            op = m.pop("op", None)
            if op == "compute-tasks":
                events.extend(self._to_events(m.get("tasks") or []))
                continue
            sid = m.get("stimulus_id", "")
            if op == "compute-task":
                m["run_spec"] = unwrap(m.get("run_spec"))
                m["priority"] = tuple(m.get("priority") or ())
                fields = ComputeTaskEvent.__dataclass_fields__
                m = {
                    k: v for k, v in m.items()
                    if k in fields
                    and (v is not None or k in ("run_spec", "span_id"))
                }
                events.append(ComputeTaskEvent(**m))
            elif op == "free-keys":
                events.append(FreeKeysEvent(
                    stimulus_id=sid, keys=tuple(m.get("keys") or ())
                ))
            elif op == "remove-replicas":
                events.append(RemoveReplicasEvent(
                    stimulus_id=sid, keys=tuple(m.get("keys") or ())
                ))
            elif op == "acquire-replicas":
                events.append(AcquireReplicasEvent(
                    stimulus_id=sid, who_has=m.get("who_has") or {},
                    nbytes=m.get("nbytes") or {},
                ))
            elif op == "steal-request":
                events.append(StealRequestEvent(
                    stimulus_id=sid, key=m.get("key", "")
                ))
            elif op == "refresh-who-has":
                events.append(RefreshWhoHasEvent(
                    stimulus_id=sid, who_has=m.get("who_has") or {}
                ))
            elif op == "worker-status-change":
                status = m.get("status", "")
                if status == "paused":
                    events.append(PauseEvent(stimulus_id=sid))
                elif status == "running":
                    events.append(UnpauseEvent(stimulus_id=sid))
            else:
                self.sim.faults["worker-unknown-op"] += 1
        return events

    def deliver(self, msgs: list[dict]) -> None:
        if not self.alive:
            return
        events = self._to_events(msgs)
        if events:
            self.handle(*events)

    def handle(self, *events: StateMachineEvent) -> None:
        """Feed events into the real state machine and act on the
        instructions (the sans-io twin of Worker.handle_stimulus)."""
        if not self.alive:
            return
        instructions = self.state.handle_stimulus(*events)
        self._dispatch(instructions)

    # ---------------------------------------------------- instruction sinks

    def _dispatch(self, instructions: list[Instruction]) -> None:
        sim = self.sim
        now = sim.clock()
        sched_msgs: list[dict] = []
        for inst in instructions:
            if isinstance(inst, SendMessageToScheduler):
                sched_msgs.append(inst.to_dict())
            elif isinstance(inst, Execute):
                self._start_execute(inst, now)
            elif isinstance(inst, GatherDep):
                sim._start_gather(self, inst)
            elif isinstance(inst, RetryBusyWorkerLater):
                worker = inst.worker
                sim.heap.at(
                    now + RETRY_BUSY_DELAY,
                    lambda w=worker: self.handle(RetryBusyWorkerEvent(
                        stimulus_id=sim.seq("retry-busy"), worker=w
                    )),
                )
            else:  # pragma: no cover - future instruction types
                raise TypeError(f"unknown instruction {inst!r}")
        if sched_msgs:
            sim._bus_to_scheduler(self, sched_msgs)

    def _start_execute(self, inst: Execute, now: float) -> None:
        key = inst.key
        duration, _nbytes = self.sim.task_profile(key)
        duration *= self.duration_scale
        # pick the earliest-free thread slot (lowest index on ties):
        # the state machine already bounds outstanding Executes, this
        # models the executor pool's serialization of the overflow
        slot = min(range(len(self.slots)), key=lambda i: (self.slots[i], i))
        t0 = max(now, self.slots[slot])
        done = t0 + duration
        self.slots[slot] = done
        self.sim.heap.at(
            done, lambda: self._finish_execute(key, t0, done)
        )

    def _finish_execute(self, key: str, t0: float, t1: float) -> None:
        if not self.alive:
            return
        sim = self.sim
        self.n_executed += 1
        if key in sim.task_errors:
            ev: StateMachineEvent = ExecuteFailureEvent(
                stimulus_id=sim.seq("execute-failure"), key=key,
                exception="SimulatedTaskError", traceback=None,
                exception_text="SimulatedTaskError()",
                traceback_text="", start=t0, stop=t1,
            )
        else:
            _dur, nbytes = sim.task_profile(key)
            ev = ExecuteSuccessEvent(
                stimulus_id=sim.seq("execute-success"), key=key,
                value=nbytes, start=t0, stop=t1, nbytes=nbytes,
            )
        self.handle(ev)


class ClusterSim:
    """A whole simulated cluster: scheduler + N workers + bus + chaos.

    Parameters
    ----------
    n_workers, nthreads:
        fleet shape; worker addresses are ``sim://w<i>``.
    seed:
        seeds the sim's RNG (available to traces/chaos as ``sim.rng``).
    links:
        a :class:`LinkProfile` (synthetic or seeded from measured
        telemetry); defaults to a uniform loopback-ish profile.
    steal_interval / amm_interval:
        virtual-second cadences of the real WorkStealing balance cycle
        and AMM round; ``None`` reads the live config defaults,
        ``0`` disables the subsystem.
    find_missing_interval:
        cadence of the worker find-missing sweep (live default 1 s).
    bus_interval:
        the virtual BatchedSend window: messages on one directed edge
        within the same ``bus_interval`` quantum coalesce into ONE
        payload (live comms batch sends the same way, ~2 ms) — this is
        both fidelity and what feeds the scheduler's batch arms real
        floods.  ``0`` delivers every send as its own payload.
    validate:
        run both state machines with invariant validation (chaos tests
        turn this on; the 10k bench leaves it off).
    use_device_kernels:
        keep ``scheduler.jax.*`` / the mirror enabled so steal/AMM/
        placement may dispatch the device kernels.  Off by default: the
        pure-python oracles are the determinism-first substrate.
    config_overrides:
        extra dot-path config overrides applied during construction AND
        during every ``run()`` window — the policy A/B driver's knob.
    ledger_size:
        decision-ledger ring rows (``None`` = the live config default).
        Size it above the workload's peak concurrent open decisions and
        every row joins — the virtual clock makes decision→outcome
        joins exact, so ``run()`` reports zero unjoined rows and a
        bit-identical ``state.ledger.digest()`` across same-seed runs.
    """

    def __init__(
        self,
        n_workers: int,
        *,
        nthreads: int = 1,
        seed: int = 0,
        links: LinkProfile | None = None,
        steal_interval: float | None = None,
        amm_interval: float | None = None,
        find_missing_interval: float = 1.0,
        bus_interval: float = 0.002,
        validate: bool = False,
        use_device_kernels: bool = False,
        config_overrides: dict[str, Any] | None = None,
        ledger_size: int | None = None,
        native: bool | None = None,
        device: Any = None,
    ):
        self.clock = VirtualClock()
        self.heap = EventHeap()
        self.links = links if links is not None else LinkProfile(seed=seed)
        self.seed = int(seed)
        self.rng = random.Random(seed)
        self.n_workers = int(n_workers)
        self.nthreads = int(nthreads)
        self.validate = bool(validate)
        self.use_device_kernels = bool(use_device_kernels)

        self._overrides: dict[str, Any] = {
            # no per-worker 16k-slot rings: 10k workers would preallocate
            # ~10^8 slot lists.  Journal capture is independent of this.
            "scheduler.trace.enabled": False,
            "scheduler.trace.ring-size": 2,
            "scheduler.validate": self.validate,
            "worker.validate": self.validate,
        }
        if not use_device_kernels:
            # the device-kernel gates read config at call time, so this
            # override must also wrap run() windows
            self._overrides["scheduler.jax.enabled"] = False
        if ledger_size is not None:
            self._overrides["scheduler.ledger.size"] = int(ledger_size)
        # native transition engine (scheduler/native_engine.py): None =
        # the config default (attach if the library is already built);
        # False = force the pure-python oracle (the A/B baseline arm);
        # True = attach, compiling on demand.  Same-seed digests are
        # bit-identical EITHER way — that is the engine's contract and
        # the sim parity tests' subject.
        self.native = native
        if native is False:
            self._overrides["scheduler.native-engine.enabled"] = False
        self._overrides.update(config_overrides or {})

        # deterministic per-run stimulus-id mint (seq_name is a
        # process-global counter — ids would differ between two runs)
        self._seq_counters: defaultdict[str, int] = defaultdict(int)

        self.faults: defaultdict[str, int] = defaultdict(int)
        self.counters: defaultdict[str, int] = defaultdict(int)
        self._task_profiles: dict[str, tuple[float, int]] = {}
        self.task_errors: set[str] = set()

        # scheduler durability harness (enable_durability/bounce_scheduler)
        self.durability: Any | None = None
        self.keys_wanted: set[str] = set()
        self.keys_done: set[str] = set()
        self.keys_lost: set[str] = set()  # lost-data client reports
        self.on_key_memory: list[Callable[[ClusterSim, str], None]] = []
        self._sources_active = 0
        self.makespan: float | None = None

        # per-directed-edge FIFO guard: streams never reorder
        self._edge_clock: dict[tuple[str, str], float] = {}
        self.bus_interval = float(bus_interval)
        # (src, dst, quantum) -> pending payload for that flush instant
        self._bus_buffers: dict[tuple[str, str, float], list] = {}

        with config.set(self._overrides):
            self.state = SchedulerState(
                validate=self.validate,
                mirror=None if self.use_device_kernels else False,
                clock=self.clock,
                device=device,
            )
            if native is True and not self.validate:
                self.state.attach_native(build=True)
            # decision-ledger digest (ledger.py): opt-in live (a blake2b
            # fold per join), always on under the virtual clock — the
            # same-seed bit-identical-ledger contract costs nothing a
            # sim cares about
            self.state.ledger.digest_enabled = True
            self.host = SimSchedulerHost(self, self.state)
            self.state.extensions = self.host.extensions
            self.workers: dict[str, SimWorker] = {}
            for i in range(self.n_workers):
                self._add_worker(f"sim://w{i}")

            from distributed_tpu_torch.scheduler.amm import (
                ActiveMemoryManagerExtension,
                ReduceReplicas,
            )
            from distributed_tpu_torch.scheduler.stealing import WorkStealing

            self.stealing = WorkStealing(self.host)
            self.stealing.clock = self.clock
            self.stealing.seq = self.seq
            self.host.extensions["stealing"] = self.stealing
            self.amm = ActiveMemoryManagerExtension(
                self.host, policies=[ReduceReplicas()],
                register=False, start=False,
            )
            self.amm.seq = self.seq
            self.host.extensions["amm"] = self.amm

            self.steal_interval = (
                steal_interval if steal_interval is not None
                else config.parse_timedelta(
                    config.get("scheduler.work-stealing-interval")
                )
            )
            self.amm_interval = (
                amm_interval if amm_interval is not None
                else config.parse_timedelta(
                    config.get("scheduler.active-memory-manager.interval")
                )
            )
        self.find_missing_interval = float(find_missing_interval)
        self._periodics_armed = False

    # ------------------------------------------------------------- identity

    def seq(self, prefix: str) -> str:
        """Deterministic per-run stimulus ids: ``sim-<prefix>-<n>``."""
        n = self._seq_counters[prefix]
        self._seq_counters[prefix] = n + 1
        return f"sim-{prefix}-{n}"

    def _add_worker(self, address: str) -> None:
        wstate = WorkerState(
            nthreads=self.nthreads, address=address,
            validate=self.validate, clock=self.clock,
        )
        self.workers[address] = SimWorker(self, address, wstate)
        self.state.add_worker_state(
            address, nthreads=self.nthreads, memory_limit=2**31,
            name=address,
        )

    # ------------------------------------------------------- task profiles

    def set_task_profile(self, key: str, duration: float, nbytes: int) -> None:
        self._task_profiles[key] = (float(duration), int(nbytes))

    def task_profile(self, key: str) -> tuple[float, int]:
        return self._task_profiles.get(
            key, (DEFAULT_DURATION, DEFAULT_NBYTES)
        )

    def forget_task_profile(self, key: str) -> None:
        self._task_profiles.pop(key, None)

    # ------------------------------------------------------------ ingress

    def scatter(self, placements: dict[str, tuple[str, int]],
                client: str = "sim-scatter") -> None:
        """Land pure data directly: ``key -> (worker_address, nbytes)``.
        The scheduler registers the replica through the engine
        (released -> memory) and the worker stores it through its real
        UpdateDataEvent path, exactly like a client scatter.  ``client``
        holds the keys (scattered data has no run_spec — unwanted it
        would be collected immediately); release with
        ``release_keys(keys, client)`` once consumers are wired."""
        stim = self.seq("scatter")
        state = self.state
        for key, (addr, nbytes) in placements.items():
            self._task_profiles[key] = (0.0, int(nbytes))
            # the journaled scatter twin (the same pure body the live
            # Scheduler.scatter drives): client interest + the engine's
            # released->memory hop, replayable from a journal tail
            cm, wm = state.stimulus_scatter_data(
                key, [addr], int(nbytes), client, stim
            )
            self._route_scheduler_output(cm, wm)
            w = self.workers[addr]
            w.handle(UpdateDataEvent(
                stimulus_id=stim, data={key: nbytes}, report=False
            ))

    def submit(
        self,
        tasks: Iterable[str] | dict[str, Any],
        dependencies: dict[str, set[str]],
        keys: Iterable[str],
        priorities: dict[str, tuple] | None = None,
        client: str = "sim",
    ) -> None:
        """Submit a (chunk of a) graph through the real
        ``update_graph_core``.  ``tasks`` may be a key iterable (every
        task gets the shared SIM_SPEC) or a full key->spec dict."""
        if not isinstance(tasks, dict):
            tasks = {k: SIM_SPEC for k in tasks}
        keys = list(keys)
        self.keys_wanted.update(keys)
        with config.set(self._overrides):
            cm, wm = self.state.update_graph_core(
                tasks, dependencies, keys, client=client,
                priorities=priorities,
                stimulus_id=self.seq("update-graph"),
            )
        self._route_scheduler_output(cm, wm)

    def release_keys(self, keys: Iterable[str], client: str = "sim") -> None:
        keys = list(keys)
        self.keys_wanted.difference_update(keys)
        self.keys_done.difference_update(keys)
        cm, wm = self.state.client_releases_keys(
            keys, client, self.seq("client-releases-keys")
        )
        self._route_scheduler_output(cm, wm)

    # ----------------------------------------------------------- the bus

    def _fifo_arrival(self, src: str, dst: str, t: float) -> float:
        """Per-directed-edge FIFO: a later send never arrives before an
        earlier one (streams are ordered)."""
        key = (src, dst)
        last = self._edge_clock.get(key, 0.0)
        t = max(t, last)
        self._edge_clock[key] = t
        return t

    def _edge_send(self, src: str, dst: str, msgs: list,
                   deliver: Callable[[list], None]) -> None:
        """One batched-stream send: coalesce with everything else on
        this directed edge landing in the same ``bus_interval`` quantum
        (the live BatchedSend window), FIFO per edge either way."""
        arrival = self.clock() + self.links.control_latency(src, dst)
        if self.bus_interval <= 0:
            self.heap.at(
                self._fifo_arrival(src, dst, arrival),
                lambda m=msgs: deliver(m),
            )
            return
        q = (int(arrival / self.bus_interval) + 1) * self.bus_interval
        key = (src, dst, q)
        buf = self._bus_buffers.get(key)
        if buf is None:
            buf = self._bus_buffers[key] = []
            self.heap.at(
                q, lambda k=key: deliver(self._bus_buffers.pop(k))
            )
        buf.extend(msgs)

    def _route_scheduler_output(self, client_msgs: dict,
                                worker_msgs: dict) -> None:
        for addr, msgs in worker_msgs.items():
            worker = self.workers.get(addr)
            if worker is None or not worker.alive:
                self.counters["msgs_to_dead_worker"] += len(msgs)
                continue
            self.counters["sched_to_worker_msgs"] += len(msgs)
            self._edge_send(SCHEDULER, addr, msgs, worker.deliver)
        if client_msgs:
            self._client_deliver(client_msgs)

    def _bus_to_scheduler(self, worker: SimWorker, msgs: list[dict]) -> None:
        self.counters["worker_to_sched_msgs"] += len(msgs)
        addr = worker.address
        self._edge_send(
            addr, SCHEDULER, msgs,
            lambda m, a=addr: self._sched_deliver(a, m),
        )

    def inject_worker_messages(self, source: str, msgs: list[dict],
                               at: float) -> None:
        """Chaos hook: deliver raw worker->scheduler op dicts at virtual
        time ``at`` as if ``source`` sent them (poison floods)."""
        self.heap.at(at, lambda: self._sched_deliver(source, list(msgs)))

    def inject_scheduler_messages(self, dest: str, msgs: list[dict],
                                  at: float) -> None:
        """Chaos hook: deliver raw scheduler->worker op dicts at ``at``."""
        def fire():
            w = self.workers.get(dest)
            if w is not None:
                w.deliver(list(msgs))
        self.heap.at(at, fire)

    # --------------------------------------------------- scheduler ingress

    _BATCH_OPS = ("task-finished", "task-erred", "release-worker-data")

    def _sched_deliver(self, worker_addr: str, msgs: list[dict]) -> None:
        """One worker payload enters the scheduler control plane:
        consecutive same-op runs fold into the batched engine arms
        exactly as ``rpc.core.handle_stream`` folds live floods."""
        state = self.state
        out_c: dict = {}
        out_w: dict = {}

        def merge(cm: dict, wm: dict) -> None:
            for dst, src in ((out_c, cm), (out_w, wm)):
                for k, v in src.items():
                    dst.setdefault(k, []).extend(v)

        # no config.set here: deliveries only fire inside run()'s
        # override window (20k redundant context entries profiled hot)
        i, n = 0, len(msgs)
        while i < n:
            op = msgs[i].get("op")
            if op in self._BATCH_OPS:
                j = i
                run = []
                while j < n and msgs[j].get("op") == op:
                    mm = dict(msgs[j])
                    mm.pop("op", None)
                    run.append(mm)
                    j += 1
                i = j
                self.counters[f"ingress_{op}"] += len(run)
                if op == "task-finished":
                    merge(*state.stimulus_tasks_finished_batch([
                        (
                            mm.pop("key", ""),
                            mm.pop("worker", "") or worker_addr,
                            mm.pop("stimulus_id", "")
                            or self.seq("igr-task-finished"),
                            mm,
                        )
                        for mm in run
                    ]))
                elif op == "task-erred":
                    merge(*state.stimulus_tasks_erred_batch([
                        (
                            mm.pop("key", ""),
                            mm.pop("worker", "") or worker_addr,
                            mm.pop("stimulus_id", "")
                            or self.seq("igr-task-erred"),
                            mm,
                        )
                        for mm in run
                    ]))
                else:
                    def rounds(run=run):
                        for mm in run:
                            sid = (
                                mm.get("stimulus_id")
                                or self.seq("igr-release-data")
                            )
                            recs = state.stimulus_release_worker_data(
                                mm.get("key", ""),
                                mm.get("worker", "") or worker_addr,
                                sid,
                            )
                            if recs:
                                yield (recs, sid)
                    merge(*state.transitions_batch(rounds()))
            else:
                merge(*self._sched_scalar(worker_addr, dict(msgs[i])))
                i += 1
        self.host.send_all(out_c, out_w)

    def _sched_scalar(self, worker_addr: str, m: dict) -> tuple[dict, dict]:
        op = m.pop("op", None)
        sid = m.get("stimulus_id", "") or self.seq(f"igr-{op}")
        state = self.state
        self.counters[f"ingress_{op}"] += 1
        if op == "add-keys":
            return state.stimulus_add_keys(
                m.get("keys") or (), worker_addr, sid
            )
        if op == "long-running":
            return state.stimulus_long_running(
                m.get("key", ""), worker_addr,
                float(m.get("compute_duration") or 0.0), sid,
            )
        if op == "reschedule":
            return state.stimulus_reschedule(m.get("key", ""), worker_addr, sid)
        if op == "missing-data":
            return state.stimulus_missing_data(
                m.get("key", ""), m.get("errant_worker", ""), sid
            )
        if op == "request-refresh-who-has":
            return state.stimulus_request_refresh_who_has(
                m.get("keys") or (), worker_addr, sid
            )
        if op == "steal-response":
            handler = self.host.stream_handlers.get("steal-response")
            if handler is not None:
                self._drive_sync(handler(
                    key=m.get("key", ""), state=m.get("state"),
                    stimulus_id=sid, worker=worker_addr,
                ))
            return {}, {}
        self.faults["scheduler-unknown-op"] += 1
        return {}, {}

    @staticmethod
    def _drive_sync(coro: Any) -> None:
        """Run a coroutine handler that never actually awaits
        (``move_task_confirm``) to completion without an event loop."""
        if coro is None or not hasattr(coro, "send"):
            return
        try:
            coro.send(None)
        except StopIteration:
            return
        raise RuntimeError(
            "stream handler suspended on a real await inside the sans-io "
            "simulator"
        )

    # --------------------------------------------------------- data plane

    def _start_gather(self, worker: SimWorker, inst: GatherDep) -> None:
        """Model one GatherDep fetch: link latency + bytes/bandwidth of
        virtual delay, then success with the peer's data — or a network
        failure if the peer is dead or partitioned at delivery time."""
        now = self.clock()
        src = inst.worker  # serving peer
        dst = worker.address
        seconds = self.links.transfer_seconds(src, dst, inst.total_nbytes)
        self.counters["gathers"] += 1
        self.heap.at(
            now + seconds,
            lambda: self._finish_gather(worker, inst, now),
        )

    def _finish_gather(self, worker: SimWorker, inst: GatherDep,
                       started: float) -> None:
        if not worker.alive:
            return
        sim_now = self.clock()
        src = inst.worker
        dst = worker.address
        server = self.workers.get(src)
        if (
            server is None
            or not server.alive
            or not self.links.reachable(src, dst, sim_now)
        ):
            self.counters["gather_failures"] += 1
            worker.handle(GatherDepNetworkFailureEvent(
                stimulus_id=self.seq("gather-net-fail"),
                worker=src, keys=tuple(inst.to_gather),
            ))
            return
        data = {
            k: server.state.data[k]
            for k in inst.to_gather
            if k in server.state.data
        }
        total = sum(self.task_profile(k)[1] for k in data)
        # measured-truth telemetry: the requesting end files the
        # authoritative bandwidth sample, the serving end its true-wire
        # cross-check — both with VIRTUAL seconds, so the fleet EWMAs a
        # simulated run builds reproduce the link profile it ran over.
        # Empty fetches (the peer freed the keys mid-flight) file
        # NOTHING on either end, mirroring the live guards: a 0 B/s
        # sample would poison the bandwidth EWMA, and one-sided filing
        # would break the both-ends-in-lockstep sample-count invariant
        if total > 0:
            elapsed = sim_now - started
            self.state.telemetry.record(src, dst, total, elapsed)
            self.state.telemetry.record_peer(src, dst, total, elapsed)
        worker.handle(GatherDepSuccessEvent(
            stimulus_id=self.seq("gather-success"),
            worker=src, data=data, total_nbytes=total,
        ))

    # --------------------------------------------------------- client plane

    def _client_deliver(self, client_msgs: dict) -> None:
        for _client, msgs in client_msgs.items():
            for m in msgs:
                op = m.get("op")
                if op == "key-in-memory":
                    key = m.get("key", "")
                    self.keys_done.add(key)
                    self.keys_lost.discard(key)
                    for cb in self.on_key_memory:
                        cb(self, key)
                elif op == "task-erred":
                    self.counters["client_task_erred"] += 1
                elif op == "lost-data":
                    self.keys_lost.add(m.get("key", ""))
                    self.counters["client_lost_data"] += 1
                elif op == "task-retried":
                    self.counters["client_task_retried"] += 1
        if self.makespan is None and self.workload_done():
            self.makespan = self.clock()

    def workload_done(self) -> bool:
        return (
            self._sources_active == 0
            and bool(self.keys_wanted)
            and self.keys_wanted <= self.keys_done
        )

    # ----------------------------------------------------------- periodics

    def source_started(self) -> None:
        self._sources_active += 1

    def source_finished(self) -> None:
        self._sources_active -= 1
        if self.makespan is None and self.workload_done():
            self.makespan = self.clock()

    def _arm_periodics(self) -> None:
        if self._periodics_armed:
            return
        self._periodics_armed = True
        # honor the live kill-switch: config "scheduler.work-stealing"
        # False (an A/B arm) must not be overridden by the sim cadence
        if self.steal_interval and self.stealing.enabled:
            self._tick_steal()
        if self.amm_interval:
            self._tick_amm()
        if self.find_missing_interval:
            self._tick_find_missing()
        # DTPU_CENSUS_CHECK: run the walk-vs-counter census audits
        # THROUGHOUT the run (scheduler + every alive worker) on the
        # steal cadence, not only at the quiesce gate — the sim twin of
        # the live sentinel's check mode (diagnostics/census.py)
        if self.state.census.check:
            self._tick_census_audit()

    def _tick_census_audit(self) -> None:
        if self.workload_done():
            return
        self.heap.at(
            self.clock() + max(self.steal_interval or 0.05, 0.05),
            self._run_census_audit,
        )

    def _run_census_audit(self) -> None:
        self.state.census.audit()
        for w in self.workers.values():
            if w.alive:
                w.state.census.audit()
        self.counters["census_audits"] += 1
        self._tick_census_audit()

    def _tick_steal(self) -> None:
        if self.workload_done():
            return  # stop re-arming: let the heap drain
        self.heap.at(self.clock() + self.steal_interval, self._run_steal)

    def _run_steal(self) -> None:
        with config.set(self._overrides):
            self.stealing.balance()
        self.counters["steal_cycles"] += 1
        self._tick_steal()

    def _tick_amm(self) -> None:
        if self.workload_done():
            return
        self.heap.at(self.clock() + self.amm_interval, self._run_amm)

    def _run_amm(self) -> None:
        with config.set(self._overrides):
            self.amm.run_once()
        self.counters["amm_cycles"] += 1
        self._tick_amm()

    def _tick_find_missing(self) -> None:
        if self.workload_done():
            return
        self.heap.at(
            self.clock() + self.find_missing_interval,
            self._run_find_missing,
        )

    def _run_find_missing(self) -> None:
        for w in self.workers.values():
            if w.alive and any(
                ts.state == "missing" for ts in w.state.tasks.values()
            ):
                w.handle(FindMissingEvent(
                    stimulus_id=self.seq("find-missing")
                ))
        self._tick_find_missing()

    # ---------------------------------------------------------------- chaos

    def kill_worker(self, address: str, at: float,
                    detect_delay: float = 0.5) -> None:
        """Worker death: the process vanishes at ``at`` (its pending
        events become no-ops, peers' fetches from it fail); the
        scheduler learns ``detect_delay`` later — the live TTL/
        comm-closed window — and reschedules through the real
        ``remove_worker_state`` cascade."""
        def die():
            w = self.workers.get(address)
            if w is None or not w.alive:
                return
            w.alive = False
            self.counters["workers_killed"] += 1
            self.heap.at(
                self.clock() + detect_delay,
                lambda: self._remove_worker(address),
            )
        self.heap.at(at, die)

    def _remove_worker(self, address: str) -> None:
        if address not in self.state.workers:
            return
        with config.set(self._overrides):
            cm, wm = self.state.remove_worker_state(
                address, stimulus_id=self.seq("remove-worker"), safe=False
            )
        self._route_scheduler_output(cm, wm)
        for ext in self.host.extensions.values():
            cb = getattr(ext, "remove_worker", None)
            if cb is not None:
                cb(self.host, address)

    def partition(self, side_a: Iterable[str], side_b: Iterable[str],
                  t0: float, t1: float) -> None:
        """Cut the DATA plane between two worker groups for the window
        ``[t0, t1)``.  The control plane (worker<->scheduler) stays up —
        the scenario where only peer fetch traffic is dropped, which is
        the one the missing-data/refresh-who-has recovery path owns."""
        self.links.add_partition(list(side_a), list(side_b), t0, t1)

    def straggler(self, address: str, factor: float) -> None:
        self.workers[address].duration_scale = float(factor)

    # ------------------------------------------------------------ journal

    def journal_start(self) -> None:
        """Begin a replayable stimulus capture on the scheduler engine
        (tracing.FlightRecorder.journal_start): the journal a sim run
        records replays through the LIVE batched engine bit-identically
        (tests/test_sim.py), and a live-recorded journal replays here."""
        _not_in_port("the stimulus journal", "the flight-recorder journal and its replay")

    def journal(self) -> list[dict]:
        return list(self.state.trace.journal)

    # --------------------------------------------------------- durability

    def enable_durability(self, *, snapshot_interval: float = 0.05,
                          full_every: int = 4) -> Any:
        """Arm scheduler durability (scheduler/durability.py) against an
        in-memory sink: an epoch-0 base snapshot now, then incremental
        snapshots every ``snapshot_interval`` virtual seconds, with the
        stimulus journal segment-captured in between.  The substrate of
        :func:`sim.chaos.scenario_scheduler_bounce`."""
        _not_in_port("scheduler durability", "durability")

    def bounce_scheduler(self, at: float) -> None:
        """Chaos hook: crash the scheduler PROCESS at virtual time
        ``at`` — its in-memory state (engine truth, stealing index,
        ledger, digest plugins) is discarded — and restart it from the
        durable snapshot + journal-tail, asserting the reconstruction
        is bit-identical to the state that died (docs/durability.md).

        Workers and their state machines survive (that is the real
        topology of a scheduler bounce); messages in flight on the bus
        deliver to the restarted scheduler — the sim models a lossless
        control-plane handover, while the messier lost-in-flight /
        re-registration path is proven on the live restart bench."""
        _not_in_port("scheduler durability", "durability")

    # ------------------------------------------------------------ running

    def run(self, max_virtual: float | None = None,
            max_events: int | None = None) -> dict:
        """Pop the event heap to exhaustion (or a cap), advancing the
        virtual clock.  Returns :meth:`report`."""
        self._arm_periodics()
        heap = self.heap
        clock = self.clock
        n = 0
        with config.set(self._overrides):
            while heap:
                if max_virtual is not None and heap.peek_time() > max_virtual:
                    break
                t, fn = heap.pop()
                clock.advance_to(t)
                fn()
                n += 1
                if max_events is not None and n >= max_events:
                    break
        if self.makespan is None and self.workload_done():
            self.makespan = clock()
        return self.report()

    # ------------------------------------------------------------- results

    def worker_transitions(self) -> int:
        return sum(w.state.transition_counter for w in self.workers.values())

    def digest(self) -> str:
        """Whole-run digest: the scheduler transition stream (folded
        incrementally by the digest plugin if installed — see
        ``install_digest``), virtual makespan, and both machines'
        transition counters.  Bit-identical across same-seed runs in
        one process."""
        h = hashlib.blake2b(digest_size=16)
        plug = self.state.plugins.get("sim-digest")
        if plug is not None:
            h.update(plug.hexdigest().encode())
        h.update(repr(self.makespan).encode())
        h.update(str(self.state.transition_counter).encode())
        h.update(str(self.worker_transitions()).encode())
        h.update(str(sorted(self.keys_done)).encode())
        return h.hexdigest()

    def install_digest(self) -> "TransitionDigest":
        plug = TransitionDigest()
        self.state.plugins["sim-digest"] = plug
        return plug

    def critical_path(self, t0: float = 0.0) -> dict | None:
        """Critical-path attribution over this run's ledger rows and
        the LIVE task graph (diagnostics/critical_path.py) — call
        before releasing the terminal keys, while the path's tasks are
        still resident.  The terminal is pinned to the workload's done
        keys: a stolen duplicate finishing after the sink was computed
        elsewhere must not extend the path past the makespan."""
        _not_in_port(
            "critical-path attribution",
            "the flight-recorder journal and its replay, critical_path",
        )

    def report(self) -> dict:
        return {
            "n_workers": self.n_workers,
            "n_alive": sum(1 for w in self.workers.values() if w.alive),
            "virtual_makespan_s": self.makespan,
            "virtual_now_s": self.clock(),
            "keys_wanted": len(self.keys_wanted),
            "keys_done": len(self.keys_done),
            "keys_lost": len(self.keys_lost),
            "scheduler_transitions": self.state.transition_counter,
            "worker_transitions": self.worker_transitions(),
            "events": self.heap.popped,
            "steals": self.stealing.count,
            "counters": dict(self.counters),
            "faults": dict(self.faults),
            # decision–outcome audit (ledger.py): per-kind regret for
            # both cost models, join health, the ledger digest — the
            # regret report the A/B driver diffs per arm
            "ledger": self.state.ledger.summary(),
        }


class TransitionDigest:
    """Scheduler-plugin digest: folds every transition's
    ``(key, start, finish, stimulus_id)`` into a running blake2b as it
    happens — the transition_log is a bounded deque, so a whole-run
    digest cannot be taken from it after the fact."""

    # consumes only (key, start, finish, stimulus_id) — the native
    # engine's tape carries exactly those, so this plugin may stay
    # installed while floods run natively (native_engine.py replays
    # plugin.transition per tape row in stream order); any plugin
    # WITHOUT this marker forces the pure-python oracle
    tape_safe = True

    def __init__(self):
        self._h = hashlib.blake2b(digest_size=16)
        self.n = 0

    def transition(self, key: str, start: str, finish: str,
                   *args: Any, stimulus_id: str = "", **kwargs: Any) -> None:
        self._h.update(
            f"{key}\x00{start}\x00{finish}\x00{stimulus_id}\n".encode()
        )
        self.n += 1

    def hexdigest(self) -> str:
        return self._h.hexdigest()
