"""Worker server: the async shell around the sans-IO state machine.

Equivalent of the reference's ``Worker`` (worker.py:264) +
``BaseWorker`` (worker_state_machine.py:3589): a ``Server`` with RPC
handlers (get_data, run, ...) and stream handlers that translate scheduler
ops into state-machine events; instructions coming back out of
``WorkerState.handle_stimulus`` are turned into asyncio tasks
(Execute -> thread pool, GatherDep -> peer RPC) whose outcomes are fed
back in as new events — the only bridge between the pure state machine
and IO.

The port's copy of ``distributed_tpu/worker/server.py``, line for line
but for these seams:

- The reference's ``jax_coordinator`` join (``:312-337``) is gone: the
  port joins ``torch.distributed``'s process group from a config preload
  (``worker/join.py``, ``worker/setup.py``), which runs before the worker
  registers, and sets ``jax_device_indices``, which the registration
  sends as the reference's does.
- The worker builds no native library at start (the reference prebuilds
  its host library, ``:308-310``): nothing on the port's worker calls one.
"""

from __future__ import annotations

import asyncio
import logging
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any

from distributed_tpu_torch import config
from distributed_tpu_torch.comm.core import Comm, connect
from distributed_tpu_torch.diagnostics import device_profile
from distributed_tpu_torch.exceptions import CommClosedError, Reschedule, WorkerClosedError
from distributed_tpu_torch.graph.spec import Key
from distributed_tpu_torch.protocol.serialize import Serialize, unwrap
from distributed_tpu_torch.rpc.batched import BatchedSend
from distributed_tpu_torch.rpc.core import PeriodicCallback, Server, Status, error_message
from distributed_tpu_torch.utils.misc import (
    format_exception,
    seq_name,
    time,
    truncate_exception,
)
from distributed_tpu_torch.utils.sizeof import sizeof
from distributed_tpu_torch.worker.state_machine import (
    AcquireReplicasEvent,
    ComputeTaskEvent,
    Execute,
    ExecuteFailureEvent,
    ExecuteSuccessEvent,
    FindMissingEvent,
    FreeKeysEvent,
    GatherDep,
    GatherDepBusyEvent,
    GatherDepFailureEvent,
    GatherDepNetworkFailureEvent,
    GatherDepSuccessEvent,
    Instruction,
    PauseEvent,
    RefreshWhoHasEvent,
    RemoveReplicasEvent,
    RescheduleEvent,
    RetryBusyWorkerEvent,
    RetryBusyWorkerLater,
    SendMessageToScheduler,
    StateMachineEvent,
    StealRequestEvent,
    UnpauseEvent,
    UpdateDataEvent,
    WorkerState,
)

logger = logging.getLogger("distributed_tpu_torch.worker")


class Worker(Server):
    """Executes tasks, stores results, serves peers (reference worker.py:264)."""

    blocked_handlers_config_key = "worker.blocked-handlers"
    preload_config_prefix = "worker"

    def __init__(
        self,
        scheduler_addr: str,
        *,
        nthreads: int | None = None,
        name: object = None,
        memory_limit: int = 0,
        resources: dict[str, float] | None = None,
        validate: bool | None = None,
        heartbeat_interval: float | None = None,
        listen_addr: str | None = None,
        http_port: int | None = 0,
        security: Any | None = None,
        lifetime: float | None = None,
        lifetime_stagger: float | None = None,
        nanny_addr: str | None = None,
        **server_kwargs: Any,
    ):
        self.nanny_addr = nanny_addr
        # multi-host device plane: a config preload's process-group join
        # (worker/join.py) sets the global mesh indices this process owns,
        # which the registration reports so device-plane shuffles pin
        # work to owners
        self.jax_device_indices: list[int] | None = None
        self._http_port = http_port
        self.http_server = None
        self.monitor = None
        self.scheduler_addr = scheduler_addr
        self.security = security
        if security is not None:
            server_kwargs.setdefault(
                "connection_args", security.get_connection_args("worker")
            )
        self.nthreads = nthreads or 1
        self.memory_limit = memory_limit
        self._listen_addr = listen_addr
        from distributed_tpu_torch.worker import resolve_lifetime

        self.lifetime, self.lifetime_stagger, _ = resolve_lifetime(
            lifetime, lifetime_stagger
        )
        self._lifetime_task: Any | None = None
        data = None
        if memory_limit:
            from distributed_tpu_torch.utils.diskutils import WorkSpace
            from distributed_tpu_torch.worker.spill import SpillBuffer

            mem_cfg = config.get("worker.memory")
            self._work_dir = WorkSpace().new_work_dir(prefix="spill")
            data = SpillBuffer(
                self._work_dir.path,
                target=int(mem_cfg["target"] * memory_limit),
                metrics_cb=lambda label, value, unit: self._fine_metric(
                    "spill", None, "", label, unit, value
                ),
            )
        self.state = WorkerState(
            nthreads=self.nthreads,
            # config fallback mirrors the reference's worker.resources
            # yaml knob: a fleet-wide resource advertisement without
            # per-worker CLI flags
            resources=(
                resources
                if resources is not None
                else dict(config.get("worker.resources") or {})
            ),
            validate=validate,
            data=data,
            execute_pipeline=int(config.get("worker.execute-pipeline") or 0),
            execute_pipeline_threshold=config.parse_timedelta(
                config.get("worker.execute-pipeline-threshold") or "5ms"
            ),
        )
        self.data = self.state.data
        # unique prefix per worker: the statistical profiler samples by
        # thread-name match, and with many in-process workers
        # (LocalCluster) each profiler must see only ITS OWN executor
        # threads — a shared prefix makes sampling O(workers^2)
        self._exec_prefix = f"dtpu-worker-exec-{id(self):x}"
        self.executor = ThreadPoolExecutor(
            self.nthreads, thread_name_prefix=self._exec_prefix
        )
        # actors serialize state access on their own single thread
        # (reference worker.py "actor" executor)
        self.actor_executor = ThreadPoolExecutor(
            1, thread_name_prefix="dtpu-worker-actor"
        )
        self.batched_stream = BatchedSend()
        self._stream_event_buffer: list[StateMachineEvent] = []
        self._stream_flush_scheduled = False
        # inline fast path: per-prefix EMA of IN-THREAD task duration
        # (measured around the bare fn call, executor overhead excluded)
        # + a loop-budget window so inlining can never starve the loop
        self._inline_threshold = config.parse_timedelta(
            config.get("worker.inline-threshold") or "0"
        )
        self._prefix_inner_ema: dict[str, float] = {}
        self._inline_window_t0 = 0.0
        self._inline_spent = 0.0
        # cumulative peer-serve counters (observability + benchmarks:
        # placement quality shows up directly as fewer get_data serves)
        self.get_data_requests = 0
        self.get_data_keys_served = 0
        self.get_data_wire_bytes = 0
        # concurrent get_data serves (reply writes included); beyond the
        # limit peers get {"status": "busy"} (reference
        # connections.outgoing, worker.py:~1740)
        self._outgoing_serves = 0
        self._outgoing_limit = int(
            (config.get("worker.connections") or {}).get("outgoing") or 50
        )
        self.scheduler_comm: Comm | None = None
        self.heartbeat_interval = (
            heartbeat_interval if heartbeat_interval is not None else 1.0
        )
        # monotonic count of local pause/unpause flips; stamped onto
        # worker-status-change messages and every heartbeat so the
        # scheduler can order a delayed heartbeat's status view against
        # stream-delivered flips (see Scheduler.heartbeat_worker)
        self._status_seq = 0
        self.plugins: dict[str, Any] = {}
        self._pubsub_subs: dict[str, list] = {}
        self._async_instructions: set[asyncio.Task] = set()
        self._local_directory: Any | None = None
        from distributed_tpu_torch.worker.metrics import FineMetrics

        self.fine_metrics = FineMetrics()
        # measured-truth transfer telemetry (telemetry.py): both ends of
        # every get_data/gather_dep transfer file (src, dst, nbytes,
        # seconds) here; heartbeats ship the since-last delta to the
        # scheduler's fleet aggregate (docs/observability.md)
        from distributed_tpu_torch.telemetry import EWMA, LinkTelemetry

        self.telemetry = LinkTelemetry()
        # heartbeat round-trip EWMA, measured with monotonic stamps
        # around the heartbeat RPC; shipped on the NEXT heartbeat and
        # exposed as dtpu_link_heartbeat_rtt_seconds scheduler-side
        self._hb_rtt = EWMA(self.telemetry.alpha)

        handlers = {
            "get_data": self.get_data,
            "gather": self.gather,
            "run": self.run_function,
            "update_data": self.update_data_handler,
            "free_keys": self.handle_free_keys_rpc,
            "actor_execute": self.actor_execute,
            "actor_attribute": self.actor_attribute,
            "profile": self.get_profile,
            "versions": self.get_versions,
            "benchmark_hardware": self.benchmark_hardware_handler,
            "memory_trace": self.memory_trace_handler,
            "device_profile": self.device_profile_handler,
            "terminate": self.close_rpc,
            "plugin_add": self.plugin_add,
            "plugin_remove": self.plugin_remove,
            "get_telemetry": self.get_telemetry,
            "get_census": self.get_census,
        }
        stream_handlers = {
            "compute-task": self._stream_compute_task,
            "compute-tasks": self._stream_compute_tasks,
            "free-keys": self._stream_free_keys,
            "remove-replicas": self._stream_remove_replicas,
            "acquire-replicas": self._stream_acquire_replicas,
            "steal-request": self._stream_steal_request,
            "refresh-who-has": self._stream_refresh_who_has,
            "worker-status-change": self._stream_status_change,
            "close-worker": self._stream_close,
            "pubsub-msg": self._stream_pubsub_msg,
        }
        super().__init__(
            handlers=handlers, stream_handlers=stream_handlers, name=name,
            **server_kwargs,
        )
        # one causal timeline for the role: the server's flight recorder
        # IS the state machine's (the /trace route and get_trace RPC
        # serve the sans-io engine's stimulus events)
        self.trace = self.state.trace
        self.name = name if name is not None else self.id
        from distributed_tpu_torch.shuffle.core import ShuffleWorkerExtension

        self.shuffle = ShuffleWorkerExtension(self)
        self.profiler = None
        if config.get("worker.profile.enabled"):
            from distributed_tpu_torch.diagnostics.profile import Profiler

            # sample exactly our executor threads, and only while
            # something is executing — N in-proc workers enumerating
            # every process thread at 100 Hz starved the event loop.
            # _threads is ThreadPoolExecutor-private: if a future
            # executor lacks it, fall back to the name-filter path
            # rather than silently sampling nothing
            idents = None
            if hasattr(self.executor, "_threads"):

                def idents() -> list:
                    # the pool grows its _threads set concurrently with
                    # submit(); retry the snapshot instead of letting a
                    # transient RuntimeError kill this worker's profiling
                    for _ in range(3):
                        try:
                            return [t.ident for t in self.executor._threads]
                        except RuntimeError:
                            continue
                    return []

            self.profiler = Profiler(
                thread_filter=self._exec_prefix,
                idents=idents,
                active=lambda: bool(self.state.executing),
            )
        # control-plane self-profiling (diagnostics/selfprofile.py):
        # this worker's EVENT-LOOP thread — the gather_dep/execute
        # dispatch plane the executor profiler above cannot see.  Wired
        # at start_unsafe (the loop ident is only known there).
        self.cp_profiler: Any | None = None
        self.watchdog: Any | None = None
        self.memory_manager = None
        if memory_limit:
            from distributed_tpu_torch.worker.memory import WorkerMemoryManager

            self.memory_manager = WorkerMemoryManager(self, memory_limit)

    # ------------------------------------------------------------ lifecycle

    async def start_unsafe(self) -> "Worker":
        self.loop = asyncio.get_running_loop()
        addr = self._listen_addr
        if addr is None:
            addr = "tcp://127.0.0.1:0"
        listen_args = (
            self.security.get_listen_args("worker")
            if self.security is not None else {}
        )
        await self.listen(addr, **listen_args)
        self.state.address = self.address
        from distributed_tpu_torch.diagnostics.system_monitor import SystemMonitor
        from distributed_tpu_torch.http.server import HTTPServer, worker_metrics

        self.monitor = SystemMonitor(
            maxlen=int(config.get("admin.system-monitor.log-length"))
        )
        self.periodic_callbacks["monitor"] = PeriodicCallback(
            self.monitor.update,
            config.parse_timedelta(
                config.get("admin.system-monitor.interval")
            ),
        )
        # control-plane self-profiling: sample this worker's loop thread
        # + stall watchdog (same scheduler.profile subtree as the
        # scheduler's, like the shared trace config)
        if config.get("scheduler.profile.enabled", True):
            from distributed_tpu_torch.diagnostics.selfprofile import (
                ControlPlaneProfiler,
                LoopWatchdog,
            )

            loop_ident = threading.get_ident()  # we run ON the loop here
            self.cp_profiler = ControlPlaneProfiler(
                idents=lambda: [loop_ident], wall=self.state.wall
            )
            self.cp_profiler.start()
            self.watchdog = LoopWatchdog(trace=self.trace, wall=self.state.wall)
            self.periodic_callbacks["loop-watchdog"] = PeriodicCallback(
                self.watchdog.tick, self.watchdog.interval
            )
            self.watchdog.start(loop_ident)
        # retention sentinel over this worker's state census — same
        # contract as the scheduler role (diagnostics/census.py;
        # docs/observability.md "State census & retention")
        if config.get("scheduler.census.enabled", True):
            from distributed_tpu_torch.diagnostics.census import RetentionSentinel

            census = self.state.census
            census.sentinel = sentinel = RetentionSentinel(
                census, trace=self.trace,
            )

            def _enriched(fut) -> None:
                exc = fut.exception()
                if exc is not None:
                    logger.warning(
                        "census finding enrichment failed: %r", exc
                    )

            def _census_tick() -> None:
                fresh = sentinel.tick()
                if fresh:
                    asyncio.get_running_loop().run_in_executor(
                        None, census.enrich_findings, fresh
                    ).add_done_callback(_enriched)

            self.periodic_callbacks["census-sentinel"] = PeriodicCallback(
                _census_tick,
                config.parse_timedelta(
                    config.get("scheduler.census.interval")
                ),
            )
        if self._http_port is not None:
            from distributed_tpu_torch.diagnostics.selfprofile import profile_jsonl
            from distributed_tpu_torch.tracing import to_jsonl

            routes: dict = {
                    "/health": lambda: "ok",
                    "/info": self.identity,
                    "/metrics": lambda: worker_metrics(self),
                    "/sysmon": lambda: self.monitor.range_query(),
                    # flight-recorder tail (docs/observability.md)
                    "/trace": lambda: (
                        to_jsonl(self.trace.tail()),
                        "application/x-ndjson",
                    ),
                    # measured-truth telemetry snapshot: this node's
                    # per-link EWMAs + t-digest quantiles as JSONL
                    # (telemetry.py; docs/observability.md)
                    "/telemetry": lambda: (
                        to_jsonl(self.telemetry.snapshot()),
                        "application/x-ndjson",
                    ),
                    # state census: this worker's per-family resident
                    # counts + findings (diagnostics/census.py;
                    # docs/observability.md "State census & retention")
                    "/census": lambda: (
                        to_jsonl(self.state.census.snapshot()),
                        "application/x-ndjson",
                    ),
                    # control-plane self-profile (loop tree + wall
                    # budget + stalls) plus the executor profile tree
                    # (docs/observability.md "Self-profiling")
                    "/profile": lambda: (
                        profile_jsonl(
                            "worker", self.cp_profiler, self.state.wall,
                            self.watchdog,
                            extra_trees=(
                                {"exec": self.profiler.get_profile()}
                                if self.profiler is not None else None
                            ),
                        ),
                        "application/x-ndjson",
                    ),
            }
            # route index at "/": same discoverability contract as the
            # scheduler role — one GET lists every route this node
            # serves (the scheduler's index additionally lists /ledger;
            # decisions are scheduler-side, so workers have no ledger)
            routes["/"] = lambda: {
                "role": "worker",
                "id": self.id,
                "routes": sorted(r for r in routes if r != "/"),
            }
            self.http_server = HTTPServer(routes, port=self._http_port)
            await self.http_server.start()
        # config preloads run BEFORE registration (reference worker
        # ordering): the scheduler may assign tasks the moment the
        # worker registers, and dtpu_setup must have prepared the
        # environment by then.  Idempotent: Server.start's later call
        # becomes a no-op.
        await self._start_config_preloads()
        await self._register_with_scheduler()
        if self.heartbeat_interval > 0:
            self.periodic_callbacks["heartbeat"] = PeriodicCallback(
                self.heartbeat, self.heartbeat_interval
            )
        self.periodic_callbacks["find-missing"] = PeriodicCallback(
            self.find_missing, 1.0
        )
        if self.profiler is not None:
            self.profiler.start()
        if self.lifetime:
            self._lifetime_task = asyncio.create_task(self._lifetime_close())
        self.start_periodic_callbacks()
        return self

    async def _lifetime_close(self) -> None:
        """Standalone --lifetime: retire gracefully after the deadline
        (reference worker.py lifetime / close_gracefully).  Under a Nanny
        the NANNY owns the lifetime (it can also restart); this path is
        for bare workers."""
        from distributed_tpu_torch.worker import sample_lifetime_delay

        delay = sample_lifetime_delay(self.lifetime, self.lifetime_stagger)
        await asyncio.sleep(delay)
        logger.info(
            "worker %s reached its lifetime (%.0fs); retiring", self.address,
            delay,
        )
        try:
            await self.rpc(self.scheduler_addr).retire_workers(
                workers=[self.address]
            )
        except Exception:
            logger.warning("lifetime retire failed", exc_info=True)
        self._ongoing_background_tasks.call_soon(self.close)

    def _register_backoff(self, purpose: str):
        """One backoff policy for both registration loops: exponential
        from ``worker.register.base-delay`` capped at ``.max-delay``,
        jittered in [0.5, 1.5) by an rng seeded per (worker id,
        purpose) — deterministic in tests, decorrelated across a fleet
        re-registering after a scheduler bounce.  Returns
        ``delay(attempt)`` with attempts counted from 1."""
        import random

        base = config.parse_timedelta(
            config.get("worker.register.base-delay")
        )
        max_delay = config.parse_timedelta(
            config.get("worker.register.max-delay")
        )
        rng = random.Random(f"{self.id}-{purpose}")

        def delay(attempt: int) -> float:
            return min(max_delay, base * 2 ** (attempt - 1)) * (
                0.5 + rng.random()
            )

        return delay

    async def _register_with_scheduler(self) -> None:
        """Handshake + dual stream with the scheduler (reference
        worker.py:1164), with retry/backoff + jitter: a handshake that
        times out (or whose reply is lost) retries on a fresh comm —
        safe because the scheduler side is idempotent per ``server_id``
        (a retry after a half-applied registration reuses the state
        row; replicas and occupancy never double-count)."""
        retries = int(config.get("worker.register.retries"))
        backoff = self._register_backoff("register")
        attempt = 0
        while True:
            try:
                await self._register_once()
                return
            except (CommClosedError, OSError, asyncio.TimeoutError) as exc:
                attempt += 1
                if attempt > retries:
                    raise
                delay = backoff(attempt)
                logger.info(
                    "register-worker attempt %d/%d failed (%s); retrying "
                    "in %.2fs", attempt, retries, exc, delay,
                )
                await asyncio.sleep(delay)

    async def _register_once(self) -> None:
        comm = await connect(self.scheduler_addr, **self.connection_args)
        from distributed_tpu_torch.scheduler.durability import worker_held_keys
        from distributed_tpu_torch.versions import get_versions

        try:
            await comm.write(
                {
                    "op": "register-worker",
                    "address": self.address,
                    "nthreads": self.nthreads,
                    "nanny": self.nanny_addr,
                    "name": self.name,
                    "memory_limit": self.memory_limit,
                    "resources": self.state.total_resources,
                    "server_id": self.id,
                    "versions": get_versions(),
                    "jax_devices": self.jax_device_indices,
                    # stored data inventory: a restarted scheduler's
                    # recovery window rebuilds/cross-checks who_has
                    # from this (scheduler/durability.py)
                    "held_keys": worker_held_keys(self.state),
                    "reply": False,
                }
            )
            # bounded read: a scheduler that accepted the connection but
            # wedged before replying must not hang registration forever
            # — the retry loop above owns recovery
            resp = await asyncio.wait_for(
                comm.read(),
                timeout=config.parse_timedelta(
                    config.get("comm.timeouts.connect")
                ) or 30.0,
            )
        except BaseException:
            await comm.close()
            raise
        if resp.get("status") != "OK":
            await comm.close()
            raise ValueError(f"scheduler rejected worker: {resp!r}")
        self.scheduler_comm = comm
        self.batched_stream.start(comm)
        self._ongoing_background_tasks.call_soon(self.handle_scheduler, comm)
        logger.info("%s registered with scheduler %s", self.address, self.scheduler_addr)

    async def handle_scheduler(self, comm: Comm) -> None:
        """Read scheduler->worker stream ops until the comm dies."""
        try:
            await self.handle_stream(comm)
        finally:
            if self.status not in (Status.closing, Status.closed, Status.failed):
                attempts = int(config.get("worker.reconnect-attempts"))
                if attempts > 0 and await self._reconnect_to_scheduler(attempts):
                    return
                logger.info("connection to scheduler lost; closing %s", self.address)
                await self.close()

    async def _reconnect_to_scheduler(self, attempts: int) -> bool:
        """Scheduler-bounce survival: the stream died but this worker
        keeps its data and state machine — re-register with backoff +
        jitter (carrying ``held_keys``) so a restarted scheduler's
        recovery window can rebuild ``who_has`` instead of recomputing
        everything this worker already holds."""
        backoff = self._register_backoff("reconnect")
        for attempt in range(1, attempts + 1):
            await asyncio.sleep(backoff(attempt))
            if self.status in (Status.closing, Status.closed, Status.failed):
                return False
            # the old stream is dead: tear it down and hand the state
            # machine a fresh buffering BatchedSend before the handshake
            await self.batched_stream.close()
            self.batched_stream = BatchedSend()
            if self.scheduler_comm is not None:
                await self.scheduler_comm.close()
                self.scheduler_comm = None
            try:
                await self._register_once()
            except (CommClosedError, OSError, asyncio.TimeoutError,
                    ValueError) as exc:
                logger.info(
                    "scheduler reconnect attempt %d/%d failed: %s",
                    attempt, attempts, exc,
                )
                continue
            logger.info(
                "%s reconnected to scheduler after %d attempt(s)",
                self.address, attempt,
            )
            return True
        return False

    async def heartbeat(self) -> None:
        if self.batched_stream.closed():
            return
        delta = self.fine_metrics.take()
        link_delta = self.telemetry.take()
        t0 = time()
        try:
            resp = await self.rpc(self.scheduler_addr).heartbeat_worker(
                address=self.address,
                now=time(),
                metrics=self.metrics(),
                fine_metrics=self.fine_metrics.rows(delta),
                link_telemetry=self.telemetry.rows(link_delta),
                # last-known round-trip EWMA: the CURRENT trip's rtt is
                # only known after this call returns, so each heartbeat
                # carries the previous measurement (0.0 until the
                # second heartbeat; the scheduler skips zeros)
                rtt=self._hb_rtt.value if self._hb_rtt.count else 0.0,
                # paused/running travels with every heartbeat: the
                # event-driven worker-status-change message is lossy at
                # the edges (a pause during startup fires before the
                # batched stream exists and is swallowed), and a
                # scheduler that thinks a paused worker is running never
                # frees its tasks for stealing
                executing_status="paused" if not self.state.running
                else "running",
                status_seq=self._status_seq,
            )
            self._hb_rtt.update(time() - t0)
            if resp.get("status") == "missing":
                # scheduler forgot us (e.g. after its restart): re-register
                await self.close()
        except (CommClosedError, OSError):
            # don't lose the activity samples to a transient blip
            self.fine_metrics.restore(delta)
            self.telemetry.restore(link_delta)

    def data_store_summary(self) -> dict:
        """One source of truth for the data-store/spill snapshot
        (metrics heartbeats and memory-trace reports both use it)."""
        out = {
            "keys": len(self.data),
            "managed_bytes": self.state.nbytes_in_memory,
        }
        if hasattr(self.data, "spilled_count"):
            out["spilled_count"] = self.data.spilled_count
            out["spilled_bytes"] = self.data.slow_bytes
        return out

    def metrics(self) -> dict:
        store = self.data_store_summary()
        out = {
            "executing": len(self.state.executing),
            "ready": len(self.state.ready),
            "in_flight": len(self.state.in_flight_tasks),
            "in_memory": store["keys"],
            "memory": store["managed_bytes"],
        }
        if self.monitor is not None:
            out["host"] = self.monitor.recent()
        if "spilled_count" in store:
            out["spilled_count"] = store["spilled_count"]
            out["spilled_bytes"] = store["spilled_bytes"]
        return out

    async def find_missing(self) -> None:
        if any(ts.state == "missing" for ts in self.state.tasks.values()):
            self.handle_stimulus(FindMissingEvent(stimulus_id=seq_name("find-missing")))

    async def close(self, timeout: float | None = None, *, report: bool = True) -> None:
        if self.status in (Status.closed, Status.closing):
            await self.finished()
            return
        self.status = Status.closing
        await self._teardown_config_preloads()
        logger.info("closing worker %s", self.address)
        if self._lifetime_task is not None:
            self._lifetime_task.cancel()
            self._lifetime_task = None
        for pc in self.periodic_callbacks.values():
            pc.stop()
        for plugin in list(self.plugins.values()):
            teardown = getattr(plugin, "teardown", None)
            if teardown is not None:
                try:
                    res = teardown(self)
                    if asyncio.iscoroutine(res):
                        await res
                except Exception:
                    logger.exception("plugin teardown failed")
        for task in list(self._async_instructions):
            task.cancel()
        if self._async_instructions:
            await asyncio.gather(*self._async_instructions, return_exceptions=True)
        await self.batched_stream.close()
        if self.scheduler_comm is not None:
            await self.scheduler_comm.close()
        if self.profiler is not None:
            self.profiler.stop()
        if self.watchdog is not None:
            self.watchdog.stop()
        if self.cp_profiler is not None:
            self.cp_profiler.stop()  # flushes the in-flight cycle
        self.executor.shutdown(wait=False)
        self.actor_executor.shutdown(wait=False)
        # release any memory-trace hold this server owns: a worker
        # closed mid-trace must not leave the process-global
        # tracemalloc unstoppable (diagnostics/memtrace.py refcounts
        # per owner; discard is a no-op when we never started one)
        from distributed_tpu_torch.diagnostics import memtrace

        memtrace.stop_trace(owner=self.id)
        if hasattr(self.data, "close"):
            self.data.close()
        if self.http_server is not None:
            await self.http_server.stop()
        await super().close()

    async def close_rpc(self, reason: str = "") -> str:
        self._ongoing_background_tasks.call_soon(self.close)
        return "OK"

    async def _stream_close(self, **kwargs: Any) -> None:
        self._ongoing_background_tasks.call_soon(self.close)

    # --------------------------------------------------------- RPC handlers

    async def get_data(
        self, comm: Comm, keys: tuple = (), who: str | None = None,
        reply: bool = True, **kwargs: Any
    ) -> Any:
        """Serve locally-held task data to a peer (reference worker.py:1722).

        Outgoing-serve backpressure (reference connections.outgoing=50):
        the handler writes its own reply so the WRITE — where a slow
        peer's TCP window actually blocks — counts against the limit;
        over the limit the peer gets ``{"status": "busy"}`` and retries
        elsewhere or later (GatherDepBusyEvent path)."""
        if self._outgoing_serves >= self._outgoing_limit:
            return {"status": "busy"} if reply else Status.dont_reply
        self._outgoing_serves += 1
        try:
            t0 = time()
            data = {}
            for k in keys:
                if k in self.data:
                    data[k] = Serialize(self.data[k])
            self.get_data_requests += 1
            self.get_data_keys_served += len(data)
            nbytes = {k: self.state.tasks[k].nbytes if k in self.state.tasks
                      else sizeof(self.data[k]) for k in data}
            self._fine_metric(
                "get-data", None, "", "serve", "seconds", time() - t0
            )
            self._fine_metric(
                "get-data", None, "", "serve", "bytes",
                float(sum(nbytes.values())),
            )
            if reply:
                # comm.write returns true wire bytes (post-compression,
                # incl. framing): the gap between this and the nbytes
                # sum above is the zero-copy data plane's effectiveness
                wire_bytes = await comm.write(
                    {"status": "OK", "data": data, "nbytes": nbytes}
                )
                self.get_data_wire_bytes += wire_bytes
                # serving-end link sample: true wire bytes attributed to
                # (us -> requester), as the peer CROSS-CHECK only — this
                # clock stops when comm.write returns (OS buffer), not
                # when the peer received the bytes, so it must never
                # fold into the dst-observed bandwidth EWMA.  The
                # requesting end files the authoritative sample; the
                # scheduler classifies the shipped rows by reporter
                # (telemetry.py)
                # `and data`: an empty OK reply (keys already released)
                # files nothing on the requesting end either, so the
                # two ends' per-link sample counts stay in lockstep
                if who and data:
                    self.telemetry.record_peer(
                        self.address, who, wire_bytes, time() - t0
                    )
            return Status.dont_reply
        finally:
            self._outgoing_serves -= 1

    async def get_telemetry(self) -> list[dict]:
        """This node's telemetry snapshot (JSON-safe records): the RPC
        twin of the HTTP ``/telemetry`` route (telemetry.py)."""
        return self.telemetry.snapshot()

    async def get_census(self, deep: bool = False) -> list[dict]:
        """This worker's state census (head + per-family records +
        findings): the RPC twin of the HTTP ``/census`` route
        (diagnostics/census.py; docs/observability.md)."""
        return self.state.census.snapshot(deep=deep)

    async def gather(self, who_has: dict[Key, list[str]] | None = None) -> dict:
        """Pull keys from peers into local memory (reference worker.py:1274)."""
        who_has = who_has or {}
        from distributed_tpu_torch.utils.comm import gather_from_workers

        data, missing, busy, _ = await gather_from_workers(who_has, rpc=self.rpc)
        self.handle_stimulus(
            UpdateDataEvent(stimulus_id=seq_name("gather"), data=data)
        )
        if missing or busy:
            # busy keys exist on their (saturated) holders — reported
            # separately so callers can retry them without a who_has
            # refresh
            return {"status": "partial-fail",
                    "keys": sorted(missing | busy),
                    "busy": sorted(busy)}
        return {"status": "OK"}

    async def run_function(
        self, function: Any = None, args: Any = None, kwargs: Any = None,
        wait: bool = True,
    ) -> Any:
        """Run an arbitrary function on this worker (reference worker.py run)."""
        from distributed_tpu_torch.rpc.core import run_user_function

        return await run_user_function(
            self, "dtpu_worker", function, args, kwargs, wait
        )

    async def update_data_handler(self, data: Any = None, report: bool = True) -> dict:
        """Receive scattered data (reference worker.py update_data)."""
        data = {k: unwrap(v) for k, v in (unwrap(data) or {}).items()}
        self.handle_stimulus(
            UpdateDataEvent(
                stimulus_id=seq_name("update-data"), data=data, report=report
            )
        )
        return {"status": "OK", "nbytes": {k: sizeof(v) for k, v in data.items()}}

    async def handle_free_keys_rpc(self, keys: tuple = (), stimulus_id: str = "") -> str:
        self.handle_stimulus(
            FreeKeysEvent(stimulus_id=stimulus_id or seq_name("free-keys"),
                          keys=tuple(keys))
        )
        return "OK"

    async def actor_execute(self, actor: str = "", function: str = "",
                            args: Any = None, kwargs: Any = None) -> dict:
        """Run a method on a resident actor (reference worker.py:2159)."""
        instance = self.state.actors.get(actor)
        if instance is None:
            return error_message(ValueError(f"no actor {actor!r} on this worker"))
        a = unwrap(args) or ()
        kw = unwrap(kwargs) or {}
        try:
            fn = getattr(instance, function)
            if asyncio.iscoroutinefunction(fn):
                result = await fn(*a, **kw)
            else:
                result = await asyncio.get_running_loop().run_in_executor(
                    self.actor_executor, lambda: fn(*a, **kw)
                )
            return {"status": "OK", "result": Serialize(result)}
        except Exception as e:
            return error_message(e)

    async def actor_attribute(self, actor: str = "", attribute: str = "") -> dict:
        instance = self.state.actors.get(actor)
        if instance is None:
            return error_message(ValueError(f"no actor {actor!r} on this worker"))
        try:
            return {"status": "OK", "result": Serialize(getattr(instance, attribute))}
        except Exception as e:
            return error_message(e)

    async def get_versions(self) -> dict:
        from distributed_tpu_torch.versions import get_versions

        return get_versions()

    @property
    def local_directory(self) -> str:
        """Per-worker scratch directory (reference worker.py
        local_directory): claimed lazily from the managed WorkSpace so
        plugins (UploadDirectory) and user tasks never collide in the
        process CWD — many workers on one host each get their own dir
        with stale-dir purge on restart."""
        if self._local_directory is None:
            from distributed_tpu_torch.utils.diskutils import WorkSpace

            self._local_directory = WorkSpace().new_work_dir(
                prefix="worker"
            )
        return self._local_directory.path

    async def memory_trace_handler(self, action: str = "report",
                                   top_n: int = 10) -> dict:
        """tracemalloc-backed memory introspection (the reference's
        memray role, diagnostics/memray.py:26): action = start | stop |
        report.  start/stop are refcounted per server id: with
        in-process workers (LocalCluster) one worker's stop no longer
        kills the process-global trace for every other server."""
        from distributed_tpu_torch.diagnostics import memtrace

        if action == "start":
            return memtrace.start_trace(owner=self.id)
        if action == "stop":
            return memtrace.stop_trace(owner=self.id)
        return memtrace.worker_report(self, top_n=top_n)

    async def device_profile_handler(self, action: str = "stop",
                                     logdir: str | None = None) -> dict:
        """XLA device-timeline tracing (the reference's low-level
        profiler role, profile.py:550): action = start | stop.  While a
        trace runs, every executed task is annotated with its key on the
        device timeline (see diagnostics/device_profile.py)."""
        if action == "start":
            return device_profile.start(logdir)
        return device_profile.stop()

    async def benchmark_hardware_handler(self) -> dict:
        """Tiny memory/disk bandwidth probes (reference worker benchmarks)."""
        import tempfile

        def bench() -> dict:
            out: dict = {}
            data = bytearray(64 * 2**20)
            t0 = time()
            for _ in range(4):
                bytes(data)  # memcpy
            out["memory_copy_bps"] = 4 * len(data) / max(time() - t0, 1e-9)
            with tempfile.NamedTemporaryFile(delete=True) as f:
                t0 = time()
                f.write(data)
                f.flush()
                out["disk_write_bps"] = len(data) / max(time() - t0, 1e-9)
            return out

        result = await asyncio.get_running_loop().run_in_executor(None, bench)
        return {"status": "OK", "result": Serialize(result)}

    async def get_profile(self, start: float | None = None) -> Any:
        """Sampled call tree (reference worker.py:2449)."""
        if self.profiler is None:
            from distributed_tpu_torch.diagnostics.profile import create

            return Serialize(create())
        return Serialize(self.profiler.get_profile(start=start))

    async def plugin_add(self, plugin: Any = None, name: str | None = None) -> dict:
        plugin = unwrap(plugin)
        name = name or getattr(plugin, "name", None) or f"plugin-{len(self.plugins)}"
        self.plugins[name] = plugin
        setup = getattr(plugin, "setup", None)
        if setup is not None:
            try:
                res = setup(worker=self)
                if asyncio.iscoroutine(res):
                    await res
            except Exception as e:
                return error_message(e)
        return {"status": "OK"}

    async def plugin_remove(self, name: str = "") -> dict:
        plugin = self.plugins.pop(name, None)
        if plugin is not None:
            teardown = getattr(plugin, "teardown", None)
            if teardown is not None:
                try:
                    res = teardown(self)
                    if asyncio.iscoroutine(res):
                        await res
                except Exception as e:
                    return error_message(e)
        return {"status": "OK"}

    # ------------------------------------------------------ stream handlers

    def _enqueue_stream_event(self, event: StateMachineEvent) -> None:
        """Coalesce stream stimuli within one payload: every message of
        a scheduler payload (often a whole planned tile of compute-tasks)
        lands in ONE handle_stimulus batch, so the state machine's
        communicating drain can aggregate their dep fetches into few
        GatherDep requests.  ``handle_stream`` flushes SYNCHRONOUSLY at
        each payload boundary (rpc/core.py stream_payload_flush), so no
        locally-generated event can interleave mid-payload; the
        call_soon is only a backstop for direct calls outside a stream
        (tests, debugging)."""
        self._stream_event_buffer.append(event)
        if not self._stream_flush_scheduled:
            self._stream_flush_scheduled = True
            asyncio.get_running_loop().call_soon(self.stream_payload_flush)

    def stream_payload_flush(self) -> None:
        self._stream_flush_scheduled = False
        events, self._stream_event_buffer = self._stream_event_buffer, []
        if events:
            self.handle_stimulus(*events)

    def _stream_compute_task(self, **msg: Any) -> None:
        msg.pop("op", None)
        msg["run_spec"] = unwrap(msg.get("run_spec"))
        msg["priority"] = tuple(msg.get("priority") or ())
        fields = ComputeTaskEvent.__dataclass_fields__
        msg = {
            k: v for k, v in msg.items()
            if k in fields and (v is not None or k in ("run_spec", "span_id"))
        }
        self._enqueue_stream_event(ComputeTaskEvent(**msg))

    def _stream_compute_tasks(self, tasks: list = (), **kw: Any) -> None:
        """Batch envelope from the scheduler's per-destination coalescer
        (scheduler/server.py _coalesce_worker_stream_msgs): each inner
        message is a full compute-task dict with its own stimulus_id.
        Expansion lands every task in the same payload-boundary
        handle_stimulus batch, so dep fetches still aggregate."""
        for msg in tasks:
            self._stream_compute_task(**msg)

    def _stream_free_keys(self, keys: tuple = (), stimulus_id: str = "") -> None:
        self._enqueue_stream_event(
            FreeKeysEvent(stimulus_id=stimulus_id, keys=tuple(keys))
        )

    def _stream_remove_replicas(self, keys: tuple = (), stimulus_id: str = "") -> None:
        self._enqueue_stream_event(
            RemoveReplicasEvent(stimulus_id=stimulus_id, keys=tuple(keys))
        )

    def _stream_acquire_replicas(
        self, who_has: dict | None = None, nbytes: dict | None = None,
        stimulus_id: str = "",
    ) -> None:
        self._enqueue_stream_event(
            AcquireReplicasEvent(
                stimulus_id=stimulus_id, who_has=who_has or {}, nbytes=nbytes or {}
            )
        )

    def _stream_steal_request(self, key: Key = "", stimulus_id: str = "") -> None:
        self._enqueue_stream_event(
            StealRequestEvent(stimulus_id=stimulus_id, key=key)
        )

    def _stream_refresh_who_has(self, who_has: dict | None = None,
                                stimulus_id: str = "") -> None:
        self._enqueue_stream_event(
            RefreshWhoHasEvent(
                stimulus_id=stimulus_id or seq_name("refresh"), who_has=who_has or {}
            )
        )

    def _stream_pubsub_msg(self, name: str = "", msg: Any = None,
                           **kw: Any) -> None:
        for sub in self._pubsub_subs.get(name, ()):
            sub._put(msg)

    def _stream_status_change(self, status: str = "", stimulus_id: str = "") -> None:
        if status in ("paused", "running"):
            # EVERY local flip bumps the seq, whatever initiated it —
            # heartbeats snapshotted before this flip must order behind
            # it (see Scheduler.heartbeat_worker)
            self._status_seq += 1
        if status == "paused":
            self._enqueue_stream_event(PauseEvent(stimulus_id=stimulus_id))
        elif status == "running":
            self._enqueue_stream_event(UnpauseEvent(stimulus_id=stimulus_id))

    # ------------------------------------------------- instruction execution

    def handle_stimulus(self, *events: StateMachineEvent) -> None:
        """Feed events into the state machine, act on the instructions
        (reference worker.py:1931)."""
        if self.status in (Status.closed, Status.failed):
            return
        instructions = self.state.handle_stimulus(*events)
        self._handle_instructions(instructions)

    def _handle_instructions(self, instructions: list[Instruction]) -> None:
        executes: list[Execute] = []
        for inst in instructions:
            if isinstance(inst, SendMessageToScheduler):
                msg = inst.to_dict()
                if msg.get("op") == "task-erred":
                    # exceptions cross the wire pickled
                    msg["exception"] = Serialize(msg["exception"])
                    msg["traceback"] = None
                try:
                    self.batched_stream.send(msg)
                except CommClosedError:
                    pass
            elif isinstance(inst, Execute):
                executes.append(inst)
            elif isinstance(inst, GatherDep):
                self._start_async_instruction(
                    self._gather_dep(inst.worker, inst.to_gather,
                                     inst.total_nbytes, inst.stimulus_id)
                )
            elif isinstance(inst, RetryBusyWorkerLater):
                self._ongoing_background_tasks.call_later(
                    0.15, self._retry_busy_worker, inst.worker
                )
            else:  # pragma: no cover - future instruction types
                raise TypeError(f"unknown instruction {inst!r}")
        if not executes:
            return
        # Batch gate: coalescing serializes a batch on ONE executor
        # thread and delays every task-finished event until that batch
        # returns, so only known-tiny tasks batch (the scheduler's
        # duration estimate; unknown prefixes report 0.5 s and never
        # qualify).  On multi-thread workers the batchable set is SPLIT
        # into nthreads chunks — one submission per pool thread — so
        # parallelism survives while handoffs still amortize.
        # _ensure_computing's BASE loop also emits multi-Execute lists
        # for tasks of any duration — those keep the per-task path.
        batchable: list[Execute] = []
        state = self.state
        if state.execute_pipeline:
            thresh = state.execute_pipeline_threshold
            rest: list[Execute] = []
            for inst in executes:
                ts = state.tasks.get(inst.key)
                if (
                    ts is not None
                    and not ts.actor
                    and 0.0 <= ts.duration < thresh
                ):
                    batchable.append(inst)
                else:
                    rest.append(inst)
            if len(batchable) < 2:
                rest = executes
                batchable = []
            executes = rest
        if batchable:
            T = state.nthreads
            chunk = -(-len(batchable) // T)  # ceil: T contiguous chunks
            for i in range(0, len(batchable), chunk):
                part = batchable[i:i + chunk]
                if len(part) == 1:
                    self._start_async_instruction(
                        self._execute(part[0].key, part[0].stimulus_id)
                    )
                else:
                    self._start_async_instruction(
                        self._execute_batch(
                            [(p.key, p.stimulus_id) for p in part]
                        )
                    )
        for inst in executes:
            self._start_async_instruction(
                self._execute(inst.key, inst.stimulus_id)
            )

    def _start_async_instruction(self, coro: Any) -> None:
        """Run an instruction coroutine; feed its resulting event back in
        (reference wsm.py:3603)."""
        task = asyncio.create_task(coro)
        self._async_instructions.add(task)

        def _done(task: asyncio.Task) -> None:
            self._async_instructions.discard(task)
            if task.cancelled():
                return
            exc = task.exception()
            if exc is not None:
                logger.exception("async instruction failed", exc_info=exc)
                return
            event = task.result()
            if event is not None:
                self.handle_stimulus(event)

        task.add_done_callback(_done)

    async def _retry_busy_worker(self, worker: str) -> None:
        self.handle_stimulus(
            RetryBusyWorkerEvent(stimulus_id=seq_name("retry-busy"), worker=worker)
        )

    # ------------------------------------------------------------- execute

    def _fine_metric(self, context: str, span_id: str | None, prefix: str,
                     label: str, unit: str, value: float) -> None:
        """File one activity sample: heartbeat delta + cumulative t-digest
        (reference metrics.py ContextMeter -> Worker.digest_metric)."""
        self.fine_metrics.add(context, span_id, prefix, label, unit, value)
        if unit == "seconds":
            self.digest_metric(f"{context}-{label}-seconds", value)

    def _execute_fine_metrics(self, span_id: str | None, prefix: str,
                              duration: float, nbytes: int) -> None:
        """One successful execution's activity rows, shared by _execute
        and _execute_batch: compute seconds (spans), plus the per-task
        output-bytes and task-count samples the scheduler's telemetry
        plane folds into per-prefix priors (telemetry.py
        fold_fine_rows — count makes the heartbeat sums per-task
        means)."""
        self._fine_metric(
            "execute", span_id, prefix, "compute", "seconds", duration
        )
        self._fine_metric(
            "execute", span_id, prefix, "output", "bytes", float(nbytes)
        )
        self._fine_metric("execute", span_id, prefix, "count", "tasks", 1.0)

    def _note_inner_duration(self, prefix: str, dur: float) -> None:
        """EMA of the bare in-thread fn duration per prefix (the inline
        fast-path gate).  Called from executor threads and the loop; a
        lost update under the GIL is harmless for an EMA."""
        ema = self._prefix_inner_ema.get(prefix)
        self._prefix_inner_ema[prefix] = (
            dur if ema is None else 0.7 * ema + 0.3 * dur
        )

    async def _execute_batch(self, items: list[tuple[Key, str]]) -> None:
        """Run one instruction batch of tiny sync tasks as a single
        executor submission.

        The execute-pipeline extension (state_machine._ensure_computing)
        over-fills slots with tasks whose duration estimate is tiny; all
        Execute instructions of one batch land here and cost ONE thread
        handoff and ONE completion wakeup total — the per-task
        run_in_executor round trip (~36 us serial on the bench box, plus
        self-pipe/epoll churn on the loop) was the dominant scheduler-
        side overhead for task storms.  Anything that is not a plain
        sync function (actors, async tasks, literal data, tasks whose
        state moved on) falls back to the per-task ``_execute`` path
        with identical semantics; results feed the state machine as one
        stimulus batch (one transition drain).

        KEEP IN SYNC with ``_execute``: the state filter, substitute
        failure event, metering wrappers, and success/reschedule/failure
        event construction are mirrored there — a change to either path
        (new event field, exception rule) must land in both."""
        import contextvars
        from time import perf_counter as _perf

        from distributed_tpu_torch.utils.misc import key_split
        from distributed_tpu_torch.worker.context import set_thread_worker
        from distributed_tpu_torch.worker.metrics import context_meter

        events: list[StateMachineEvent] = []
        calls: list[tuple] = []
        for key, sid in items:
            ts = self.state.tasks.get(key)
            if ts is None or ts.state not in (
                "executing", "long-running", "cancelled", "resumed"
            ):
                continue
            rs = ts.run_spec
            fn = getattr(rs, "fn", None)
            if fn is None or ts.actor or asyncio.iscoroutinefunction(fn):
                self._start_async_instruction(self._execute(key, sid))
                continue
            prefix = key_split(key)
            start = time()
            try:
                fn, args, kwargs = rs.substitute(self.data)
            except BaseException as e:  # noqa: B036 - corrupt spec / missing dep
                e2 = truncate_exception(e)
                events.append(ExecuteFailureEvent(
                    stimulus_id=sid, key=key, exception=e2, traceback=None,
                    exception_text=repr(e2),
                    traceback_text=format_exception(e),
                    start=start, stop=time(),
                ))
                continue

            def _user_metric(label, value, unit, _sid=ts.span_id, _pre=prefix):
                self._fine_metric("execute", _sid, _pre, label, unit, value)

            with context_meter.add_callback(_user_metric):
                ctx = contextvars.copy_context()
            calls.append((key, sid, ts, prefix, ctx, fn, args, kwargs))

        if calls:
            def _run_batch():
                out = []
                for key, sid, ts, prefix, ctx, fn, args, kwargs in calls:
                    def _call(fn=fn, args=args, kwargs=kwargs,
                              _pre=prefix, _key=key):
                        set_thread_worker(self, _key)
                        t0 = _perf()
                        try:
                            if device_profile.active():
                                with device_profile.annotate(_key):
                                    return fn(*args, **kwargs)
                            return fn(*args, **kwargs)
                        finally:
                            self._note_inner_duration(_pre, _perf() - t0)

                    start = time()
                    try:
                        value = ctx.run(_call)
                        out.append((key, sid, ts, "ok", value, start, time()))
                    except Reschedule:
                        out.append((key, sid, ts, "resched", None, start, time()))
                    except BaseException as e:  # noqa: B036 - user code
                        if isinstance(e, (KeyboardInterrupt, SystemExit)):
                            raise
                        out.append((
                            key, sid, ts, "err",
                            (e, format_exception(e)), start, time(),
                        ))
                return out

            batch_start = time()
            try:
                results = await asyncio.get_running_loop().run_in_executor(
                    self.executor, _run_batch
                )
            except BaseException as e:  # noqa: B036 - mirror _execute
                if isinstance(e, (KeyboardInterrupt, SystemExit)):
                    raise
                if isinstance(e, asyncio.CancelledError) and self.status in (
                    Status.closing, Status.closed, Status.failed
                ):
                    # worker shutdown cancelled the batch: propagate,
                    # exactly like _execute (no task-erred during close)
                    raise
                # a CancelledError outside shutdown (or any executor
                # failure) must not wedge the whole batch in "executing"
                # with no completion event: emit a failure per task so
                # the scheduler can retry them elsewhere.  The executor
                # thread may still be running the batch — its results
                # are dropped, which is safe (transitions ignore
                # completions for released tasks).
                stop = time()
                e2 = truncate_exception(e)
                tb_text = format_exception(e)
                for key, sid, _ts, _prefix, _ctx, _fn, _a, _kw in calls:
                    events.append(ExecuteFailureEvent(
                        stimulus_id=sid, key=key, exception=e2,
                        traceback=None, exception_text=repr(e2),
                        traceback_text=tb_text,
                        start=batch_start, stop=stop,
                    ))
                results = []
            for key, sid, ts, kind, value, start, stop in results:
                if kind == "ok":
                    self.digest_metric("compute-duration", stop - start)
                    out_nbytes = sizeof(value)
                    self._execute_fine_metrics(
                        ts.span_id, key_split(key), stop - start, out_nbytes
                    )
                    events.append(ExecuteSuccessEvent(
                        stimulus_id=sid, key=key, value=value,
                        start=start, stop=stop, nbytes=out_nbytes,
                        type=type(value).__name__,
                    ))
                elif kind == "resched":
                    events.append(RescheduleEvent(stimulus_id=sid, key=key))
                else:
                    e, tb_text = value
                    e2 = truncate_exception(e)
                    events.append(ExecuteFailureEvent(
                        stimulus_id=sid, key=key, exception=e2,
                        traceback=None, exception_text=repr(e2),
                        traceback_text=tb_text, start=start, stop=stop,
                    ))
        if events:
            self.handle_stimulus(*events)
        return None

    async def _execute(self, key: Key, stimulus_id: str) -> StateMachineEvent | None:
        """Run one task (reference worker.py:2210).

        KEEP IN SYNC with ``_execute_batch`` (see its docstring)."""
        ts = self.state.tasks.get(key)
        # "resumed" must run too: if the task was cancelled and re-requested
        # BEFORE this coroutine's first tick (busy loop), bailing out here
        # would leave it in "resumed" forever — no execution exists to
        # complete it (the round-3 mid-shuffle restart hang)
        if ts is None or ts.state not in (
            "executing", "long-running", "cancelled", "resumed"
        ):
            return None
        run_spec = ts.run_spec
        start = time()
        try:
            if hasattr(run_spec, "substitute"):
                fn, args, kwargs = run_spec.substitute(self.data)
                if asyncio.iscoroutinefunction(fn):
                    from distributed_tpu_torch.worker.context import (
                        reset_async_worker,
                        set_async_worker,
                    )

                    token = set_async_worker(self, key)
                    try:
                        value = await fn(*args, **kwargs)
                    finally:
                        reset_async_worker(token)
                else:
                    import contextvars
                    from time import perf_counter as _perf

                    from distributed_tpu_torch.utils.misc import key_split
                    from distributed_tpu_torch.worker.context import set_thread_worker
                    from distributed_tpu_torch.worker.metrics import context_meter

                    prefix = key_split(key)

                    def _user_metric(label, value, unit,
                                     _sid=ts.span_id, _pre=prefix):
                        self._fine_metric(
                            "execute", _sid, _pre, label, unit, value
                        )

                    def _call(fn=fn, args=args, kwargs=kwargs, _pre=prefix):
                        set_thread_worker(self, key)
                        t0 = _perf()
                        try:
                            if device_profile.active():
                                # device trace running: mark this task's
                                # span on the XLA timeline so its device
                                # ops group under the task key
                                with device_profile.annotate(key):
                                    return fn(*args, **kwargs)
                            return fn(*args, **kwargs)
                        finally:
                            self._note_inner_duration(_pre, _perf() - t0)

                    inline = False
                    if not ts.actor and self._inline_threshold:
                        ema = self._prefix_inner_ema.get(prefix)
                        if ema is not None and ema < self._inline_threshold:
                            nowp = _perf()
                            if nowp - self._inline_window_t0 > 0.02:
                                self._inline_window_t0 = nowp
                                self._inline_spent = 0.0
                            inline = self._inline_spent < 0.005
                    if inline:
                        # known-tiny task: the executor handoff costs
                        # more loop work than the function itself
                        t0 = _perf()
                        try:
                            with context_meter.add_callback(_user_metric):
                                value = _call()
                        finally:
                            # _call installed a thread-local task key —
                            # on the LOOP thread here; clear it or every
                            # later coroutine task on the loop reads the
                            # stale key via get_task_key()
                            set_thread_worker(None, None)
                        self._inline_spent += _perf() - t0
                    else:
                        # context_meter callbacks installed here flow
                        # into the fine metrics; copy_context propagates
                        # them into the executor thread so user task
                        # code can emit samples
                        with context_meter.add_callback(_user_metric):
                            ctx = contextvars.copy_context()
                            value = await asyncio.get_running_loop().run_in_executor(
                                self.executor, ctx.run, _call
                            )
                if ts.actor:
                    # keep the instance resident; the task's value is a
                    # placeholder resolved to an Actor proxy client-side
                    from distributed_tpu_torch.client.actor import ActorPlaceholder

                    self.state.actors[key] = value
                    value = ActorPlaceholder(type(value), key, self.address)
            else:
                value = unwrap(run_spec)  # literal data baked into the graph
            stop = time()
            self.digest_metric("compute-duration", stop - start)
            from distributed_tpu_torch.utils.misc import key_split

            out_nbytes = sizeof(value)
            self._execute_fine_metrics(
                ts.span_id, key_split(key), stop - start, out_nbytes
            )
            return ExecuteSuccessEvent(
                stimulus_id=stimulus_id,
                key=key,
                value=value,
                start=start,
                stop=stop,
                nbytes=out_nbytes,
                type=type(value).__name__,
            )
        except Reschedule:
            return RescheduleEvent(stimulus_id=stimulus_id, key=key)
        except BaseException as e:  # noqa: B036 - user code may raise anything
            if isinstance(e, (KeyboardInterrupt, SystemExit)):
                raise
            if isinstance(e, asyncio.CancelledError) and self.status in (
                Status.closing, Status.closed, Status.failed
            ):
                # worker shutdown cancelled us: propagate (no task-erred).
                # A CancelledError leaking from USER code outside shutdown
                # falls through to the failure path instead — swallowing
                # it would wedge the task in 'executing' with no
                # completion event
                raise
            stop = time()
            e2 = truncate_exception(e)
            return ExecuteFailureEvent(
                stimulus_id=stimulus_id,
                key=key,
                exception=e2,
                traceback=None,
                exception_text=repr(e2),
                traceback_text=format_exception(e),
                start=start,
                stop=stop,
            )

    # ---------------------------------------------------------- gather_dep

    async def _gather_dep(
        self, worker: str, to_gather: tuple, total_nbytes: int, stimulus_id: str
    ) -> StateMachineEvent:
        """Fetch a batch of keys from one peer (reference worker.py:2030).

        Metered through a DelayedMetricsLedger (reference metrics.py:336):
        the instruction spans many loop iterations, and its network /
        deserialize split plus the un-metered remainder ("other": loop
        contention, pool queueing) must land on THIS activity."""
        from distributed_tpu_torch.worker.metrics import (
            DelayedMetricsLedger,
            context_meter,
        )

        ledger = DelayedMetricsLedger(
            lambda label, value, unit: self._fine_metric(
                "gather-dep", None, "", label, unit, value
            )
        )
        try:
            with ledger.activity():
                net_t0 = time()
                try:
                    with context_meter.meter("network"):
                        resp = await self.rpc(worker).get_data(
                            keys=list(to_gather), who=self.address
                        )
                except (CommClosedError, OSError, asyncio.TimeoutError):
                    self.state._gather_finished(worker)
                    return GatherDepNetworkFailureEvent(
                        stimulus_id=stimulus_id, worker=worker,
                        keys=tuple(to_gather),
                    )
                except Exception as e:
                    self.state._gather_finished(worker)
                    return GatherDepFailureEvent(
                        stimulus_id=stimulus_id, worker=worker,
                        keys=tuple(to_gather), exception=e, traceback=None,
                    )
                self.state._gather_finished(worker)
                if resp.get("status") == "busy":
                    return GatherDepBusyEvent(
                        stimulus_id=stimulus_id, worker=worker,
                        keys=tuple(to_gather),
                    )
                # requesting-end link sample (peer -> us): payload bytes
                # as the SERVER sized them over the full fetch duration
                # — the cost the constant model prices, measured.
                # Failed/busy/empty fetches file nothing: no bytes moved
                # (an OK reply whose keys were already released carries
                # zero bytes, and a 0 B/s sample would poison the EWMA).
                payload_nbytes = sum((resp.get("nbytes") or {}).values())
                if payload_nbytes > 0:
                    self.telemetry.record(
                        worker, self.address, payload_nbytes,
                        time() - net_t0,
                    )
                with context_meter.meter("deserialize"):
                    data = {
                        k: unwrap(v) for k, v in resp.get("data", {}).items()
                    }
                    nbytes = sum(sizeof(v) for v in data.values())
            ledger.record("transfer", float(nbytes), "bytes")
        finally:
            # failed/busy fetches must be attributed too — a cluster
            # drowning in transfer retries would otherwise report zero
            # gather-dep network seconds
            ledger.finalize()
        return GatherDepSuccessEvent(
            stimulus_id=stimulus_id,
            worker=worker,
            data=data,
            total_nbytes=nbytes,
        )

    def __repr__(self) -> str:
        try:
            addr = self.address
        except ValueError:
            addr = "not-listening"
        return (
            f"<Worker {addr!r} status={self.status.name} "
            f"executing={len(self.state.executing)} stored={len(self.data)}>"
        )
