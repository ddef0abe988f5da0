"""Scheduler server: the async shell around ``SchedulerState``.

Equivalent of the reference's ``Scheduler`` (scheduler.py:3453) =
``SchedulerState`` + ``ServerNode``: RPC handler table
(scheduler.py:3794), batched streams to every worker and client, and
``send_all`` routing the (client_msgs, worker_msgs) produced by the pure
state machine onto those streams.

The port's copy of ``distributed_tpu/scheduler/server.py``, line for line
but for these seams:

- ``Scheduler(device=None)`` means CUDA and raises without a card; only
  ``device="cpu"`` runs on the CPU.  The device goes to the port's
  ``SchedulerState`` (its fleet mirror and periodic device paths) and to
  the placement.
- Where the reference builds ``JaxPlacement()`` when
  ``scheduler.jax.enabled`` is set (``:148-151``), the port builds
  ``TorchPlacement(device=...)``.
- :func:`default_extensions` lists the port's own extensions under the
  reference's keys: ``WorkStealing``, ``ActiveMemoryManagerExtension``,
  ``ShuffleSchedulerExtension`` and the coordination extensions.
- The native transition engine is built off the loop by the port's
  ``native.prebuild_async`` (``load_engine(build=True)`` in a thread) and
  attached when it lands, as the reference attaches its own.
- ``rebalance``'s device plan (K9) is the port's ``RebalancePath`` on
  ``state.device``, gated by the port's configuration
  (``gate.config_gate``), where the reference plans with jax.
"""

from __future__ import annotations

import asyncio
import logging
import threading
from typing import Any, Iterable

from distributed_tpu_torch import config
from distributed_tpu_torch.comm.core import Comm
from distributed_tpu_torch.exceptions import CommClosedError
from distributed_tpu_torch.graph.spec import Key
from distributed_tpu_torch.protocol.serialize import (
    OPAQUE_TYPES,
    Serialize,
    unwrap,
    wrap_opaque,
)
from distributed_tpu_torch.rpc.batched import BatchedSend
from distributed_tpu_torch.rpc.core import (
    PeriodicCallback,
    Server,
    Status,
    error_message,
)
from distributed_tpu_torch.scheduler.state import SchedulerState, WorkerState
from distributed_tpu_torch.utils.comm import gather_from_workers, scatter_to_workers
from distributed_tpu_torch.utils.misc import seq_name, time

logger = logging.getLogger("distributed_tpu_torch.scheduler")


def default_extensions() -> dict[str, Any]:
    """The DEFAULT_EXTENSIONS table (reference scheduler.py:178-193)."""
    from distributed_tpu_torch.coordination.extensions import coordination_extensions
    from distributed_tpu_torch.scheduler.amm import ActiveMemoryManagerExtension
    from distributed_tpu_torch.scheduler.stealing import WorkStealing
    from distributed_tpu_torch.shuffle.scheduler_ext import ShuffleSchedulerExtension

    return {
        "stealing": WorkStealing,
        "amm": ActiveMemoryManagerExtension,
        "shuffle": ShuffleSchedulerExtension,
        **coordination_extensions(),
    }



class _ThreadedSink:
    """Durability sink wrapper that runs every write on ONE executor
    thread: the event loop encodes snapshot/journal bytes and returns
    immediately; the fsync'd file IO (durability.FileSink) happens
    off-loop, in submission order — so a crash loses only a suffix of
    the write sequence, which is exactly the crash model the loader's
    epoch/watermark contract tolerates.  Reads are start-up-only
    (restore precedes the first write) and pass straight through."""

    def __init__(self, inner: Any):
        from concurrent.futures import ThreadPoolExecutor

        self.inner = inner
        # stats to bill journal bytes to, set after the manager exists:
        # segment serialization (digest stamping included) happens on
        # the writer thread, so the byte count is only known there
        self.stats: Any | None = None
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="dtpu-durability"
        )

    def _submit(self, fn: Any, *args: Any) -> None:
        def run() -> None:
            try:
                fn(*args)
            except Exception:
                logger.exception("durability sink write failed")

        self._pool.submit(run)

    def write_snapshot(self, epoch: int, blob: bytes) -> int:
        self._submit(self.inner.write_snapshot, epoch, blob)
        return len(blob)

    def append_journal(self, epoch: int, records: list) -> int:
        def run() -> None:
            try:
                n = self.inner.append_journal(epoch, records)
                if self.stats is not None:
                    self.stats.journal_bytes += n
            except Exception:
                logger.exception("durability sink write failed")

        self._pool.submit(run)
        return 0

    def drain(self) -> None:
        """Block until every queued write hit disk (graceful close)."""
        self._pool.shutdown(wait=True)

    def read_snapshot(self, epoch: int) -> bytes:
        return self.inner.read_snapshot(epoch)

    def read_journal(self, epoch: int) -> bytes:
        return self.inner.read_journal(epoch)

    def snapshot_epochs(self) -> list[int]:
        return self.inner.snapshot_epochs()

    def journal_epochs(self) -> list[int]:
        return self.inner.journal_epochs()


class Scheduler(Server):
    """Central control plane (reference scheduler.py:3453)."""

    default_port = 8786
    preload_config_prefix = "scheduler"

    def __init__(
        self,
        *,
        listen_addr: str | None = None,
        validate: bool | None = None,
        transition_counter_max: int | None = None,
        placement: Any | None = None,
        extensions: dict[str, Any] | None = None,
        worker_ttl: float | None = None,
        idle_timeout: float | None = None,
        http_port: int | None = 0,
        security: Any | None = None,
        device: Any = None,
        **server_kwargs: Any,
    ):
        self._http_port = http_port
        self.http_server = None
        self.monitor = None
        self._listen_addr = listen_addr
        self.security = security
        if security is not None:
            server_kwargs.setdefault(
                "connection_args", security.get_connection_args("scheduler")
            )
        if placement is None and config.get("scheduler.jax.enabled"):
            from distributed_tpu_torch.scheduler.torch_placement import TorchPlacement

            placement = TorchPlacement(device=device)
        elif placement is False:
            placement = None
        self.state = SchedulerState(
            validate=validate,
            transition_counter_max=transition_counter_max,
            placement=placement,
            device=device,
        )
        self.rebalance_path: Any | None = None  # made at the first device rebalance
        self.generation = 0
        # address -> BatchedSend for workers; client key -> BatchedSend
        self.stream_comms: dict[str, BatchedSend] = {}
        self.client_comms: dict[str, BatchedSend] = {}
        self.worker_ttl = (
            worker_ttl
            if worker_ttl is not None
            else config.parse_timedelta(config.get("scheduler.worker-ttl")) or 0
        )
        self.idle_timeout = (
            idle_timeout
            if idle_timeout is not None
            else config.parse_timedelta(config.get("scheduler.idle-timeout"))
        )
        self.idle_since: float | None = time()
        self._last_worker_seen: dict[str, float] = {}

        handlers = {
            "register-worker": self.add_worker,
            "register-client": self.add_client,
            "heartbeat_worker": self.heartbeat_worker,
            "gather": self.gather,
            "scatter": self.scatter,
            "cancel": self.stimulus_cancel,
            "retry": self.stimulus_retry,
            "who_has": self.get_who_has,
            "has_what": self.get_has_what,
            "ncores": self.get_ncores,
            "nbytes": self.get_nbytes,
            "processing": self.get_processing,
            "identity": self.identity,
            "broadcast": self.broadcast,
            "run_function": self.run_function_on_scheduler,
            "restart": self.restart,
            "get_logs": self.get_events_handler,
            "log_event": self.log_event_handler,
            "events": self.get_events_handler,
            "missing_workers": self.get_missing_workers,
            "retire_workers": self.retire_workers,
            "adaptive_target": self.adaptive_target,
            "remove_worker": self.remove_worker_handler,
            "rebalance": self.rebalance,
            "replicate": self.replicate,
            "register_scheduler_plugin": self.register_scheduler_plugin,
            "unregister_scheduler_plugin": self.unregister_scheduler_plugin,
            "register_worker_plugin": self.register_worker_plugin,
            "register_nanny_plugin": self.register_nanny_plugin,
            "unregister_nanny_plugin": self.unregister_nanny_plugin,
            "unregister_worker_plugin": self.unregister_worker_plugin,
            "get_cluster_state": self.get_cluster_state,
            "get_telemetry": self.get_telemetry,
            "get_ledger": self.get_ledger,
            "get_census": self.get_census,
            "get_runspec": self.get_runspec,
            "versions": self.versions,
            "worker_versions": self.worker_versions,
            "benchmark_hardware": self.benchmark_hardware,
            "performance_report_html": self.performance_report_html,
        }
        stream_handlers = {
            # from workers
            "task-finished": self.handle_task_finished,
            "task-erred": self.handle_task_erred,
            "release-worker-data": self.handle_release_data,
            "add-keys": self.handle_add_keys,
            "long-running": self.handle_long_running,
            "reschedule": self.handle_reschedule,
            "missing-data": self.handle_missing_data,
            "request-refresh-who-has": self.handle_request_refresh_who_has,
            "log-event": self.handle_worker_log_event,
            "worker-status-change": self.handle_worker_status_change,
            # from clients
            "update-graph": self.update_graph,
            "client-desires-keys": self.handle_client_desires_keys,
            "client-releases-keys": self.handle_client_releases_keys,
            "heartbeat-client": self.handle_heartbeat_client,
            "close-client": self.handle_close_client,
        }
        # deserialize=False: the scheduler NEVER unpickles user payloads
        # (run_specs, scattered data, results, exceptions) — they pass
        # through as opaque Serialized frames, so the scheduler process
        # needs no user code and pays no pickle cost on the hot path
        # (reference scheduler.py:3453 Server(deserialize=False)).
        # Handlers that genuinely consume content (run_function, plugin
        # registration) deserialize explicitly via unwrap().
        server_kwargs.setdefault("deserialize", False)
        super().__init__(
            handlers=handlers, stream_handlers=stream_handlers, **server_kwargs
        )
        # one causal timeline for the role: the server's flight recorder
        # IS the state machine's (ingress/egress hops land next to the
        # engine's transition events; /trace and get_trace serve both)
        self.trace = self.state.trace
        self._close_begun = False
        self.extensions: dict[str, Any] = {}
        if extensions is None:
            extensions = default_extensions()
        for name, ext_cls in extensions.items():
            self.extensions[name] = ext_cls(self)
        self.state.extensions = self.extensions
        from distributed_tpu_torch.diagnostics.spans import SpansSchedulerExtension
        from distributed_tpu_torch.diagnostics.task_stream import TaskStreamPlugin

        self.task_stream = TaskStreamPlugin(self)
        from distributed_tpu_torch.diagnostics.group_timing import GroupTimingPlugin

        self.group_timing = GroupTimingPlugin(self)
        self.handlers["get_group_timing"] = (
            lambda **kw: self.group_timing.collect()
        )
        self.spans = SpansSchedulerExtension(self)
        self._topic_subscribers: dict[str, set[str]] = {}
        # eventstream refcounting: total starts minus stops, plus a
        # per-client breakdown so a consumer that crashes without
        # calling eventstream_stop releases its references when its
        # comm closes (remove-client path) instead of pinning the
        # per-completion plugin forever
        self._eventstream_refs = 0
        self._eventstream_clients: dict[str, int] = {}
        self._eventstream_anon = 0  # starts not tied to any client
        self.state.events_subscriber_hook = self._fan_out_event
        self.worker_plugins: dict[str, Any] = {}  # shipped to joining workers
        self._nanny_plugins: dict[str, Any] = {}  # shipped to joining nannies
        self.handlers["get_task_stream"] = self.get_task_stream
        from distributed_tpu_torch.diagnostics.memory_sampler import (
            memory_sample_handler,
        )

        self.handlers["memory_sample"] = (
            lambda **kw: memory_sample_handler(self, **kw)
        )
        self.handlers["get_profile"] = self.get_profile
        self.handlers["eventstream_start"] = self.eventstream_start
        self.handlers["eventstream_stop"] = self.eventstream_stop
        self.handlers["get_computations"] = self.get_computations
        self.stream_handlers["subscribe-topic"] = self.subscribe_topic
        self.stream_handlers["unsubscribe-topic"] = self.unsubscribe_topic
        self.stream_handlers["log-event-client"] = self.handle_client_log_event
        # same-op floods within one stream payload fold into a single
        # batched state-machine pass (rpc/core.py handle_stream;
        # docs/batching.md) — the per-message handlers above remain the
        # oracle path for lone messages and direct calls
        self.stream_batch_handlers["task-finished"] = self.handle_tasks_finished
        self.stream_batch_handlers["task-erred"] = self.handle_tasks_erred
        self.stream_batch_handlers["release-worker-data"] = (
            self.handle_release_data_batch
        )
        # send_all output is staged per stream payload and flushed once
        # at the payload boundary (handle_stream calls
        # stream_payload_flush) with per-destination coalescing; the
        # call_soon backstop covers non-stream callers (RPC handlers,
        # periodic callbacks) at zero added latency — BatchedSend only
        # writes from its background task anyway
        self._pending_client_msgs: dict[str, list] = {}
        self._pending_worker_msgs: dict[str, list] = {}
        self._pending_flush_scheduled = False
        self._loop: asyncio.AbstractEventLoop | None = None  # set at start
        # control-plane self-profiling (diagnostics/selfprofile.py):
        # wired at start_unsafe when scheduler.profile.enabled — the
        # sampler watches the loop + planner threads, the watchdog
        # catches loop stalls with a traceback
        self.cp_profiler: Any | None = None
        self.watchdog: Any | None = None
        # scheduler durability (scheduler/durability.py;
        # docs/durability.md): armed at start_unsafe when
        # scheduler.durability.directory is set — restore from
        # snapshot + journal tail, then capture snapshots/segments
        self.durability: Any | None = None
        # re-registration window after a restore: restored worker
        # addresses still expected back, and the absolute (monotonic)
        # deadline after which the missing ones are removed and their
        # tasks rescheduled
        self._recovery: dict | None = None

    # ----------------------------------------------------------- lifecycle

    async def start_unsafe(self) -> "Scheduler":
        from distributed_tpu_torch import native

        self._loop = asyncio.get_running_loop()
        # async prebuild so the first flood never pays the g++ compile
        # on the event loop; once the library lands, attach the native
        # transition engine (state init could not — load_nowait returns
        # None until the build exists)
        loop = self._loop

        def _native_ready() -> None:  # runs in the build thread
            # same gate as SchedulerState.__init__: a validate=True
            # scheduler must not pay SoA maintenance for an engine
            # active() will never admit
            if (config.get("scheduler.native-engine.enabled")
                    and not self.state.validate):
                loop.call_soon_threadsafe(self.state.attach_native)

        native.prebuild_async(on_ready=_native_ready)
        # durability restore + capture arm BEFORE the listener exists:
        # nothing can register or submit against a half-restored state
        if config.get("scheduler.durability.directory"):
            self._durability_start()
        addr = self._listen_addr or "tcp://127.0.0.1:0"
        listen_args = (
            self.security.get_listen_args("scheduler")
            if self.security is not None else {}
        )
        await self.listen(addr, **listen_args)
        # observability: SystemMonitor sampling + HTTP routes
        from distributed_tpu_torch.diagnostics.system_monitor import SystemMonitor
        from distributed_tpu_torch.http.server import HTTPServer, scheduler_metrics

        self.monitor = SystemMonitor(
            maxlen=int(config.get("admin.system-monitor.log-length"))
        )
        self.periodic_callbacks["monitor"] = PeriodicCallback(
            self.monitor.update,
            config.parse_timedelta(
                config.get("admin.system-monitor.interval")
            ),
        )
        # control-plane self-profiling (diagnostics/selfprofile.py;
        # docs/observability.md "Self-profiling"): sample the event-loop
        # thread + the jax-placement planner thread at a low rate, and
        # watch the loop for stalls.  Wired BEFORE the HTTP server so
        # /profile serves real trees from its first request.
        if config.get("scheduler.profile.enabled", True):
            from distributed_tpu_torch.diagnostics.selfprofile import (
                ControlPlaneProfiler,
                LoopWatchdog,
            )

            loop_ident = threading.get_ident()  # we run ON the loop here
            placement = self.state.placement

            def _cp_idents() -> list[int]:
                ids = [loop_ident]
                if placement is not None:
                    pid = getattr(placement, "planner_ident", None)
                    pid = pid() if callable(pid) else None
                    if pid is not None:
                        ids.append(pid)
                return ids

            self.cp_profiler = ControlPlaneProfiler(
                idents=_cp_idents, wall=self.state.wall
            )
            self.cp_profiler.start()
            self.watchdog = LoopWatchdog(
                trace=self.trace, wall=self.state.wall
            )
            self.periodic_callbacks["loop-watchdog"] = PeriodicCallback(
                self.watchdog.tick, self.watchdog.interval
            )
            self.watchdog.start(loop_ident)
        # retention sentinel over the state census (diagnostics/
        # census.py; docs/observability.md "State census & retention"):
        # a low-cadence tick folds per-family growth slopes and runs
        # the census-vs-empty diff on every quiesce edge.  Fresh
        # findings get their bounded gc.get_referrers holder sample
        # OFF the loop.  The durability dirty sets are exempt from
        # LIVE quiesce diffs only — they drain on snapshot cadence
        # (the sim/bench teardown gates snapshot first and exempt
        # nothing).
        if config.get("scheduler.census.enabled", True):
            from distributed_tpu_torch.diagnostics.census import RetentionSentinel

            census = self.state.census
            census.sentinel = sentinel = RetentionSentinel(
                census, trace=self.trace,
                quiesce_allow=(
                    "durability.dirty-tasks", "durability.removed-tasks",
                    "durability.dirty-workers", "durability.removed-workers",
                ),
            )

            def _enriched(fut: Any) -> None:
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
            from distributed_tpu_torch.http.dashboard import json_api_routes

            from distributed_tpu_torch.tracing import to_jsonl

            routes: dict = {
                    "/health": lambda: "ok",
                    "/info": self.identity,
                    "/metrics": lambda: scheduler_metrics(self),
                    "/json/counts.json": self._counts_json,
                    "/sysmon": lambda: self.monitor.range_query(),
                    # flight-recorder tail as JSON Lines
                    # (docs/observability.md; schema-versioned records)
                    "/trace": lambda: (
                        to_jsonl(self.trace.tail()),
                        "application/x-ndjson",
                    ),
                    # fleet telemetry snapshot: per-link EWMAs +
                    # t-digest quantiles, prefix priors, heartbeat
                    # RTTs, divergence summary (telemetry.py)
                    "/telemetry": lambda: (
                        to_jsonl(self.state.telemetry.snapshot()),
                        "application/x-ndjson",
                    ),
                    # control-plane self-profile: wall budget + sampled
                    # loop/planner trees + recent stalls as JSONL
                    # (docs/observability.md "Self-profiling")
                    "/profile": lambda: (
                        profile_jsonl(
                            "scheduler", self.cp_profiler,
                            self.state.wall, self.watchdog,
                        ),
                        "application/x-ndjson",
                    ),
                    # decision–outcome ledger: summary head + resident
                    # row tail as JSONL (ledger.py;
                    # docs/observability.md "Decision ledger")
                    "/ledger": lambda: (
                        to_jsonl(self.state.ledger.snapshot()),
                        "application/x-ndjson",
                    ),
                    # state census: per-family resident counts + recent
                    # findings as JSONL (cheap families; the get_census
                    # RPC adds the O(n) walk families on demand —
                    # diagnostics/census.py, docs/observability.md)
                    "/census": lambda: (
                        to_jsonl(self.state.census.snapshot()),
                        "application/x-ndjson",
                    ),
                    **json_api_routes(self),
            }
            # route index at "/": observability discoverability — one
            # GET lists every route this role serves (/metrics, /trace,
            # /telemetry, /profile, /ledger, ...)
            routes["/"] = lambda: {
                "role": "scheduler",
                "id": self.id,
                "routes": sorted(r for r in routes if r != "/"),
            }
            self.http_server = HTTPServer(routes, port=self._http_port)
            await self.http_server.start()
        if self.worker_ttl:
            self.periodic_callbacks["worker-ttl"] = PeriodicCallback(
                self.check_worker_ttl, max(self.worker_ttl / 4, 0.25)
            )
        no_workers_timeout = config.parse_timedelta(
            config.get("scheduler.no-workers-timeout") or "0"
        )
        if no_workers_timeout:
            def _check_no_workers() -> None:
                cm, wm = self.state.stimulus_no_workers_timeout(
                    no_workers_timeout, seq_name("no-workers-timeout")
                )
                self.send_all(cm, wm)

            self.periodic_callbacks["no-workers-timeout"] = PeriodicCallback(
                _check_no_workers, max(no_workers_timeout / 4, 0.25)
            )
        if self.idle_timeout:
            self.periodic_callbacks["idle-timeout"] = PeriodicCallback(
                self.check_idle, max(self.idle_timeout / 4, 0.25)
            )
        if self.durability is not None:
            snap_iv = config.parse_timedelta(
                config.get("scheduler.durability.snapshot-interval")
            )
            flush_iv = config.parse_timedelta(
                config.get("scheduler.durability.flush-interval")
            )
            self.periodic_callbacks["durability-snapshot"] = PeriodicCallback(
                self._durability_snapshot, snap_iv
            )
            self.periodic_callbacks["durability-flush"] = PeriodicCallback(
                self._durability_flush, flush_iv
            )
            if self._recovery is not None:
                grace = self._recovery["grace"]
                self.periodic_callbacks["recovery-grace"] = PeriodicCallback(
                    self._check_recovery_grace, max(grace / 4, 0.05)
                )
        self.start_periodic_callbacks()
        logger.info("scheduler listening at %s", self.address)
        return self

    async def close(self, timeout: float | None = None) -> None:
        # status may already read "closing" (deploy layers flag shutdown
        # before retiring workers so per-departure recovery stands down);
        # only an actually-started close short-circuits
        if self.status == Status.closed or self._close_begun:
            await self.finished()
            return
        # the flag flips BEFORE the first await below: a concurrent
        # close() arriving while a dtpu_teardown hook runs must not
        # re-enter the body and double-close comms/extensions
        self._close_begun = True
        # dtpu_teardown hooks run against a LIVE cluster (same ordering
        # as the CLI flag path); idempotent backstop in Server.close
        await self._teardown_config_preloads()
        self.status = Status.closing
        logger.info("closing scheduler %s", self.id)
        for pc in self.periodic_callbacks.values():
            pc.stop()
        if self.watchdog is not None:
            self.watchdog.stop()
        if self.cp_profiler is not None:
            self.cp_profiler.stop()  # flushes the in-flight cycle
        placement = self.state.placement
        if placement is not None and hasattr(placement, "close"):
            placement.close()
        for ext in self.extensions.values():
            close = getattr(ext, "close", None)
            if close is not None:
                try:
                    res = close()
                    if asyncio.iscoroutine(res):
                        await res
                except Exception:
                    logger.exception("extension close failed")
        self.stream_payload_flush()  # staged sends must not die buffered
        # tell workers to shut down
        for addr, bs in list(self.stream_comms.items()):
            try:
                bs.send({"op": "close-worker"})
            except CommClosedError:
                pass
            await bs.close(timeout=0.5)
        for client, bs in list(self.client_comms.items()):
            await bs.close(timeout=0.5)
        if self.http_server is not None:
            await self.http_server.stop()
        if self.durability is not None:
            # graceful close ends the epoch cleanly: one final snapshot
            # + segment flush, then drain the write thread so the image
            # on disk is complete before the process exits
            try:
                self.durability.snapshot()
                self.durability.flush_journal()
                self.durability.sink.drain()
            except Exception:
                logger.exception("final durability snapshot failed")
        await super().close()

    # ----------------------------------------------------------- durability

    def _durability_start(self) -> None:
        """Restore from the durable image (when one exists) and arm
        capture: the recovery sequence of docs/durability.md.  Runs
        synchronously before the listener starts — a worker cannot
        register, and a client cannot submit, against a half-restored
        state."""
        from distributed_tpu_torch.diagnostics.flight_recorder import (
            replay_stimulus_trace,
        )
        from distributed_tpu_torch.scheduler import durability as dur

        directory = config.get("scheduler.durability.directory")
        sink = dur.FileSink(directory)
        state = self.state
        next_epoch = 0
        restore_info = None
        t0 = time()
        if sink.snapshot_epochs():
            folded, tail, info = dur.DurabilityManager.load(sink)
            dur.restore_state(state, folded)
            want = info.get("state_digest")
            if want:
                got = dur.state_digest(state)
                if got != want:
                    raise dur.SnapshotCorruptError(
                        f"restored state digest {got} != snapshot's "
                        f"{want}: refusing to continue from a divergent "
                        "state"
                    )
            # per-worker extension structures the live add_worker path
            # would have built, then the recorded cross-payload steal
            # truth (in-flight confirm windows, stealable levels)
            steal = self.extensions.get("stealing")
            if steal is not None:
                for ws in state.workers.values():
                    if ws.address not in steal.stealable:
                        steal.add_worker_state(ws)
                dur.restore_stealing(steal, folded.get("ext") or None)
            replay_stimulus_trace(state, tail, verify_digests=False)
            restore_info = info
            next_epoch = int(info["epoch"]) + 1
            grace = config.parse_timedelta(
                config.get("scheduler.durability.grace")
            )
            awaiting = {
                ws.address for ws in state.workers.values()
            }
            self._recovery = {
                "awaiting": awaiting,
                "deadline": time() + grace,
                "grace": grace,
                "restored_workers": len(awaiting),
            }
            logger.info(
                "restored scheduler state from %s: epoch %s (+%s deltas), "
                "%d tail records, %d tasks, %d workers awaiting "
                "re-registration (grace %.1fs)",
                directory, info["epoch"], info["deltas"], len(tail),
                len(state.tasks), len(awaiting), grace,
            )
        tsink = _ThreadedSink(sink)
        mgr = dur.DurabilityManager(state, tsink)
        tsink.stats = mgr.stats
        mgr.epoch = next_epoch
        mgr.attach()
        self.durability = mgr
        if restore_info is not None:
            st = mgr.stats
            st.replay_records = int(restore_info["tail_records"])
            st.torn_records = int(restore_info["torn_records"])
            st.restore_seconds = time() - t0

    def _durability_snapshot(self) -> None:
        mgr = self.durability
        if mgr is None:
            return
        # encode on-loop (O(changed rows) between payloads), write
        # off-loop through the single-thread sink
        info = mgr.snapshot()
        self.trace.emit(
            "durability", "snapshot", f"epoch-{info['epoch']}",
            n=info["task_rows"], dest="sink",
        )

    def _durability_flush(self) -> None:
        if self.durability is not None:
            self.durability.flush_journal()

    async def _check_recovery_grace(self) -> None:
        """Bounded re-registration window: when the grace expires,
        restored workers that never came back are removed through the
        engine — their tasks reschedule exactly like a live departure."""
        rec = self._recovery
        if rec is None:
            return
        if not rec["awaiting"]:
            self._finish_recovery()
            return
        if time() < rec["deadline"]:
            return
        missing = sorted(rec["awaiting"])
        logger.warning(
            "recovery grace expired: removing %d workers that never "
            "re-registered: %s", len(missing), missing[:5],
        )
        for address in missing:
            if address not in rec["awaiting"]:
                # re-registered while an earlier removal awaited: the
                # handshake discarded it — must not strip a live worker
                continue
            rec["awaiting"].discard(address)
            try:
                await self.remove_worker(address, "recovery-grace-expired")
            except Exception:
                logger.exception(
                    "grace-expiry removal failed for %s", address
                )
        self._finish_recovery()

    def _finish_recovery(self) -> None:
        self._recovery = None
        pc = self.periodic_callbacks.pop("recovery-grace", None)
        if pc is not None:
            pc.stop()

    # ------------------------------------------------------------ messaging

    def send_all(self, client_msgs: dict, worker_msgs: dict) -> None:
        """Route state-machine output onto the batched streams
        (reference scheduler.py:6067).

        Messages are STAGED, not written: everything produced while one
        stream payload is being processed (often a whole task-finished
        flood) flushes in a single pass at the payload boundary, where
        per-destination runs coalesce (compute-task batches, merged
        free-keys).  Order per destination is strictly preserved."""
        for client, msgs in client_msgs.items():
            self._pending_client_msgs.setdefault(client, []).extend(msgs)
        for worker, msgs in worker_msgs.items():
            self._pending_worker_msgs.setdefault(worker, []).extend(msgs)
        if self._pending_flush_scheduled:
            return
        if not (self._pending_client_msgs or self._pending_worker_msgs):
            return
        self._pending_flush_scheduled = True
        loop = self._loop
        if loop is None or loop.is_closed():
            # not started / no running loop (sync tests, teardown):
            # write through now
            self._pending_flush_scheduled = False
            self.stream_payload_flush()
        else:
            loop.call_soon(self.stream_payload_flush)

    def stream_payload_flush(self) -> None:
        """Write staged messages to the batched streams — called by
        ``handle_stream`` at every payload boundary, by the ``call_soon``
        backstop one tick after a non-stream send, and synchronously
        before anything that writes to the same streams out-of-band
        (``report``, ``restart``, ``close``) so ordering never inverts."""
        self._pending_flush_scheduled = False
        if not (self._pending_client_msgs or self._pending_worker_msgs):
            return
        client_msgs, self._pending_client_msgs = self._pending_client_msgs, {}
        worker_msgs, self._pending_worker_msgs = self._pending_worker_msgs, {}
        tr = self.trace
        wall = self.state.wall
        wall.push("egress.flush")
        try:
            self._flush_payloads(client_msgs, worker_msgs, tr)
        finally:
            wall.pop()

    def _flush_payloads(self, client_msgs: dict, worker_msgs: dict,
                        tr: Any) -> None:
        for client, msgs in client_msgs.items():
            bs = self.client_comms.get(client)
            if bs is None:
                continue
            tr.emit("egress", "client-report", "", n=len(msgs), dest=client)
            try:
                bs.send(*[self._wrap_payload(m) for m in msgs])
            except CommClosedError:
                logger.info("lost connection to client %s", client)
        for worker, msgs in worker_msgs.items():
            bs = self.stream_comms.get(worker)
            if bs is None:
                continue
            coalesced = _coalesce_worker_stream_msgs(msgs)
            # egress hop: one event per coalesced envelope, stamped with
            # the envelope's (first) stimulus id so a flood's
            # compute-tasks fan-out joins the engine pass that produced
            # it.  Envelope fold size feeds dtpu_egress_* regardless of
            # trace.enabled — the histogram is a documented /metrics
            # family, not trace output.
            hist = self.state.hist_egress
            for m in coalesced:
                op = m.get("op", "")
                if op == "compute-tasks":
                    n = len(m["tasks"])
                    stim = m["tasks"][0].get("stimulus_id", "")
                else:
                    keys = m.get("keys")
                    n = (
                        len(keys)
                        if isinstance(keys, (list, tuple))
                        else 1
                    )
                    stim = m.get("stimulus_id", "")
                hist.observe(n)
                tr.emit("egress", op, stim, n=n, dest=worker)
            try:
                bs.send(*[self._wrap_payload(m) for m in coalesced])
            except CommClosedError:
                logger.info("lost connection to worker %s", worker)
                self._ongoing_background_tasks.call_soon(
                    self.remove_worker, worker, "comm-closed"
                )

    @staticmethod
    def _wrap_payload(msg: dict) -> dict:
        """Ensure non-msgpackable payloads cross the wire pickled.

        Exceptions from workers are already opaque wrappers (this server
        never deserialized them) and pass through; scheduler-raised ones
        (KilledWorker, ...) are raw objects and get wrapped here."""
        for field in ("exception", "traceback"):
            v = msg.get(field)
            if v is not None and not isinstance(v, (*OPAQUE_TYPES, str, bytes)):
                msg = dict(msg)
                msg[field] = Serialize(v)
        return msg

    def report(self, msg: dict, *, client: str | None = None) -> None:
        """Send a message to one or all clients."""
        # report() writes the stream directly: flush staged sends first
        # so a direct message can never overtake state-machine output
        self.stream_payload_flush()
        if client is not None:
            targets = [client] if client in self.client_comms else []
        else:
            targets = list(self.client_comms)
        for c in targets:
            try:
                self.client_comms[c].send(self._wrap_payload(msg))
            except CommClosedError:
                pass

    # -------------------------------------------------------------- workers

    async def add_worker(self, comm: Comm, **kwargs: Any) -> Any:
        """Worker registration handshake; the comm becomes the dual stream
        (reference scheduler.py:4308)."""
        address = kwargs["address"]
        existing = self.state.workers.get(address)
        reregister = False
        if existing is not None:
            server_id = kwargs.get("server_id")
            stream = self.stream_comms.get(address)
            if server_id is not None and existing.server_id == server_id:
                # the SAME worker process registering again: a restored
                # scheduler's re-registration window, or a retried
                # handshake whose first reply was lost.  Idempotent by
                # server_id — the state row is reused, so replicas and
                # occupancy are never double-counted; only the stream
                # is replaced.
                reregister = True
                if stream is not None:
                    self.stream_comms.pop(address, None)
                    stream.abort()
            elif stream is None or stream.closed():
                # a NEW process took the address and the old one's
                # stream is already dead: retire the stale row first
                await self.remove_worker(address, "superseded-by-new-registration")
            else:
                await comm.write({"status": "error", "message": "worker already exists"})
                return Status.dont_reply
        if reregister:
            ws = existing
        else:
            ws = self.state.add_worker_state(
                address,
                nthreads=kwargs.get("nthreads", 1),
                memory_limit=kwargs.get("memory_limit", 0),
                name=kwargs.get("name"),
                resources=kwargs.get("resources"),
                server_id=kwargs.get("server_id"),
            )
        if kwargs.get("versions"):
            ws.extra["versions"] = kwargs["versions"]
        if kwargs.get("jax_devices") is not None:
            # global mesh device indices this worker's process owns —
            # the device-plane shuffle pins partitions to their owners
            ws.extra["jax_devices"] = list(kwargs["jax_devices"])
        if kwargs.get("nanny"):
            ws.extra["nanny"] = kwargs["nanny"]
            # late-joining nanny gets the already-registered nanny plugins
            for pname, pblob in self._nanny_plugins.items():
                self._ongoing_background_tasks.call_soon(
                    self._push_nanny_plugin, kwargs["nanny"], pname, pblob
                )
        self._last_worker_seen[address] = time()
        logger.info("register worker %s (%d threads)", address, ws.nthreads)

        # publish the (unstarted, buffering) BatchedSend before any await so
        # concurrent send_all never drops messages for this worker, but only
        # start its flush loop AFTER the registration reply is on the wire —
        # otherwise a flushed batch could precede the handshake response
        bs = BatchedSend()
        self.stream_comms[address] = bs
        await comm.write({"status": "OK", "time": time()})
        bs.start(comm)

        stimulus_id = seq_name("add-worker")
        recs = self.state.bulk_schedule_unrunnable_after_adding_worker(ws)
        client_msgs, worker_msgs = self.state.transitions(recs, stimulus_id)
        recs2 = self.state.stimulus_queue_slots_maybe_opened(stimulus_id)
        cm2, wm2 = self.state.transitions(recs2, stimulus_id)
        for d, extra in ((client_msgs, cm2), (worker_msgs, wm2)):
            for k, v in extra.items():
                d.setdefault(k, []).extend(v)
        self.send_all(client_msgs, worker_msgs)
        if self._recovery is not None:
            self._recovery["awaiting"].discard(address)
        if kwargs.get("held_keys") is not None:
            # recovery reconciliation (scheduler/durability.py): the
            # worker's reported data keys rebuild / cross-check who_has
            # — every correction routed through the engine.  Idempotent:
            # a retried registration reports the same keys and the
            # second pass finds nothing to correct.  An EMPTY list still
            # reconciles: it strips every stale restored replica this
            # worker no longer holds.
            from distributed_tpu_torch.scheduler.durability import reconcile_worker

            (cm3, wm3), counts = reconcile_worker(
                self.state, address, kwargs["held_keys"],
                seq_name("reconcile"),
            )
            corrections = (
                counts["added"] + counts["finished"] + counts["stripped"]
            )
            if corrections:
                logger.info(
                    "reconciled %s on (re)registration: %s", address, counts
                )
                if self.durability is not None:
                    self.durability.stats.reconcile_corrections += corrections
            self.send_all(cm3, wm3)
        for ext in self.extensions.values():
            cb = getattr(ext, "add_worker", None)
            if cb is not None:
                try:
                    cb(self, address)
                except Exception:
                    logger.exception("extension add_worker failed")
        for pname, plugin in self.worker_plugins.items():
            self._ongoing_background_tasks.call_soon(
                self._send_plugin_to_worker, address, pname, plugin
            )

        try:
            await self.handle_stream(comm, extra={"worker": address})
        finally:
            # remove only while THIS registration still owns the stream:
            # an idempotent re-registration (same server_id) replaces the
            # stream and aborts this one — the superseded handler waking
            # up here must not strip the freshly re-registered worker
            if self.stream_comms.get(address) is bs:
                try:
                    await self.remove_worker(address, "stream-closed")
                except Exception:
                    # a failed removal must be loud: half-applied
                    # reschedules strand tasks on a dead worker
                    logger.exception("remove_worker failed for %s", address)
        return Status.dont_reply

    async def remove_worker(self, address: str, reason: str = "", *,
                            safe: bool = False) -> None:
        """Worker left or died: reschedule its work (reference scheduler.py:5180)."""
        if address not in self.state.workers:
            return
        logger.info("remove worker %s (%s)", address, reason)
        stimulus_id = seq_name("remove-worker")
        bs = self.stream_comms.pop(address, None)
        if bs is not None:
            bs.abort()
        self._last_worker_seen.pop(address, None)
        client_msgs, worker_msgs = self.state.remove_worker_state(
            address, stimulus_id=stimulus_id, safe=safe
        )
        self.send_all(client_msgs, worker_msgs)
        for ext in self.extensions.values():
            cb = getattr(ext, "remove_worker", None)
            if cb is not None:
                try:
                    cb(self, address)
                except Exception:
                    logger.exception("extension remove_worker failed")

    async def remove_worker_handler(self, address: str = "", reason: str = "") -> str:
        await self.remove_worker(address, reason or "rpc")
        return "OK"

    async def heartbeat_worker(
        self, address: str = "", now: float = 0.0, metrics: dict | None = None,
        fine_metrics: list | None = None, executing_status: str = "",
        status_seq: int = -1, link_telemetry: list | None = None,
        rtt: float = 0.0, **kwargs: Any,
    ) -> dict:
        ws = self.state.workers.get(address)
        if ws is None:
            return {"status": "missing"}
        self._last_worker_seen[address] = time()
        ws.last_seen = time()
        if metrics:
            ws.metrics = metrics
        if fine_metrics and self.spans is not None:
            self.spans.collect_fine_metrics(fine_metrics)
        # measured-truth telemetry plane (telemetry.py): per-link
        # transfer deltas + the worker-measured heartbeat RTT fold into
        # the fleet aggregate, and the same fine-metric stream feeds the
        # per-prefix priors
        tel = self.state.telemetry
        if tel.enabled:
            with self.state.wall.phase("telemetry.fold"):
                if link_telemetry:
                    # fold only links between CURRENTLY registered
                    # workers: a row naming a peer that already left
                    # (or never completed registration) would re-create
                    # a LinkStats entry forget_worker just pruned
                    # — nothing re-prunes it, so with worker churn the
                    # link table grew without bound (the census's
                    # telemetry.links.stale family walks this to zero)
                    workers = self.state.workers
                    rows = [
                        r for r in link_telemetry
                        if r[0] in workers and r[1] in workers
                    ]
                    if rows:
                        tel.fold_rows(rows, reporter=address)
                if rtt:
                    tel.record_rtt(address, rtt)
                if fine_metrics:
                    tel.fold_fine_rows(fine_metrics)
        # reconcile pause state: the event message can be lost at
        # startup (see Worker.heartbeat) and a stale "running" view
        # pins the paused worker's tasks out of stealing forever.
        # A heartbeat that raced a fresher stream-delivered change must
        # NOT win (its snapshot predates the RPC; the spurious paused
        # flip un-homes tasks irreversibly): the worker stamps every
        # status flip AND every heartbeat with a monotonic status_seq,
        # and the heartbeat's view is applied only when provably at
        # least as new as the last flip this scheduler has seen.  (A
        # pre-seq worker — status_seq < 0 — falls back to a wall-clock
        # quiet window, the old racy heuristic.)
        if executing_status and executing_status != ws.status:
            if (
                status_seq >= ws.status_seq
                if status_seq >= 0
                else time() - ws.status_changed_at > 1.0
            ):
                self.handle_worker_status_change(
                    status=executing_status, worker=address,
                    stimulus_id=seq_name("heartbeat-status"),
                    status_seq=status_seq,
                )
        return {"status": "OK", "time": time(),
                "heartbeat-interval": self.heartbeat_interval()}

    def heartbeat_interval(self) -> float:
        """Scale heartbeat cadence with cluster size (reference scheduler.py:8749)."""
        n = len(self.state.workers)
        if n <= 10:
            return 0.5
        if n < 50:
            return 1.0
        return n / 200 + 1

    async def check_worker_ttl(self) -> None:
        """Evict workers that stopped heartbeating (reference scheduler.py:8312)."""
        now = time()
        for address, seen in list(self._last_worker_seen.items()):
            if now - seen > self.worker_ttl:
                logger.warning("worker %s missed its ttl; removing", address)
                await self.remove_worker(address, "ttl-expired")

    async def check_idle(self) -> None:
        s = self.state
        # task activity only — a connected-but-inactive client must not
        # keep an idle cluster alive forever (reference idle-timeout
        # semantics, scheduler.py:8326).  Also reset whenever the
        # transition counter advanced since the last check: bursts of
        # short tasks that start AND finish between two checks are
        # activity, not idleness (reference scheduler.py:8330).
        busy = any(ws.processing for ws in s.workers.values()) or s.queued or s.unrunnable
        if s.transition_counter != getattr(self, "_idle_transition_counter", -1):
            self._idle_transition_counter = s.transition_counter
            busy = True
        if busy:
            self.idle_since = None
            return
        if self.idle_since is None:
            self.idle_since = time()
        elif self.idle_timeout and time() - self.idle_since > self.idle_timeout:
            logger.info("scheduler idle for %.0fs; closing", time() - self.idle_since)
            self._ongoing_background_tasks.call_soon(self.close)

    # -------------------------------------------------------------- clients

    async def add_client(self, comm: Comm, client: str = "", **kwargs: Any) -> Any:
        """Client registration; the comm becomes the report stream
        (reference scheduler.py:5550)."""
        logger.info("register client %s", client)
        self.state.add_client_state(client)
        # same ordering as add_worker: publish the buffering BatchedSend
        # before any await (no dropped reports), start it only after the
        # handshake reply (no batch ahead of the handshake)
        bs = BatchedSend()
        self.client_comms[client] = bs
        await comm.write({"status": "OK", "time": time(),
                          "id": self.id, "type": type(self).__name__})
        bs.start(comm)
        try:
            await self.handle_stream(comm, extra={"client": client})
        finally:
            self.client_comms.pop(client, None)
            for subs in self._topic_subscribers.values():
                subs.discard(client)
            # a consumer that died without eventstream_stop must not pin
            # the per-completion plugin forever: drop every reference it
            # still holds now that its comm is gone
            held = self._eventstream_clients.pop(client, 0)
            if held:
                self._release_eventstream_refs(held)
            stimulus_id = seq_name("remove-client")
            client_msgs, worker_msgs = self.state.remove_client_state(
                client, stimulus_id
            )
            self.send_all(client_msgs, worker_msgs)
            logger.info("remove client %s", client)
        return Status.dont_reply

    def handle_heartbeat_client(self, client: str = "", **kwargs: Any) -> None:
        cs = self.state.clients.get(client)
        if cs is not None:
            cs.last_seen = time()

    async def handle_close_client(self, client: str = "", **kwargs: Any) -> None:
        # direct stream write: flush staged sends first or stream-closed
        # (terminal for the client's listen loop) overtakes final reports
        self.stream_payload_flush()
        bs = self.client_comms.get(client)
        if bs is not None and not bs.closed():
            try:
                bs.send({"op": "stream-closed"})
            except CommClosedError:
                pass  # the client hung up first — that's the point

    # ----------------------------------------------------------- graph intake

    async def update_graph(
        self,
        client: str = "",
        tasks: Any = None,
        dependencies: dict | None = None,
        keys: Iterable[Key] = (),
        priorities: dict | None = None,
        user_priority: Any = 0,
        annotations_by_key: dict | None = None,
        retries: Any = None,
        actors: Any = False,
        stimulus_id: str | None = None,
        **kwargs: Any,
    ) -> None:
        """Receive a task graph from a client (reference scheduler.py:4662)."""
        stimulus_id = stimulus_id or seq_name("update-graph")
        try:
            tasks = unwrap(tasks) or {}
            self._trace_ingress("update-graph", len(tasks), stimulus_id)
            deps = {
                k: set(v) for k, v in (dependencies or {}).items()
            }
            self.generation += 1
            client_msgs, worker_msgs = self.state.update_graph_core(
                tasks,
                deps,
                list(keys),
                client=client,
                priorities=priorities,
                user_priority=user_priority,
                generation=self.generation,
                annotations_by_key=annotations_by_key,
                retries=retries,
                actors=actors,
                stimulus_id=stimulus_id,
            )
            self.send_all(client_msgs, worker_msgs)
        except Exception as e:
            logger.exception("update_graph failed")
            for key in keys:
                self.report(
                    {
                        "op": "task-erred",
                        "key": key,
                        "exception": Serialize(e),
                        "traceback": None,
                    },
                    client=client,
                )

    def handle_client_desires_keys(self, keys: Iterable[Key] = (),
                                   client: str = "", **kw: Any) -> None:
        self.state.client_desires_keys(keys, client)
        for key in keys:
            ts = self.state.tasks.get(key)
            if ts is None:
                continue
            if ts.state == "memory":
                self.report({"op": "key-in-memory", "key": key}, client=client)
            elif ts.state == "erred":
                self.report(
                    {
                        "op": "task-erred",
                        "key": key,
                        "exception": ts.exception,
                        "traceback": ts.traceback,
                    },
                    client=client,
                )

    def handle_client_releases_keys(self, keys: Iterable[Key] = (),
                                    client: str = "", **kw: Any) -> None:
        stimulus_id = seq_name("client-releases-keys")
        keys = list(keys)
        self._trace_ingress("client-releases-keys", len(keys), stimulus_id)
        client_msgs, worker_msgs = self.state.client_releases_keys(
            keys, client, stimulus_id
        )
        self.send_all(client_msgs, worker_msgs)

    # ----------------------------------------------------- worker stream ops

    def _trace_ingress(self, op: str, n: int, stimulus_id: str) -> None:
        """Flight-recorder ingress hop: a stream op entered the control
        loop.  Every op on the batched plane (``stream_batch_handlers``)
        and its scalar twin MUST pass through here — enforced by the
        handler-parity lint's trace-parity pass (docs/analysis.md)."""
        self.trace.emit("ingress", op, stimulus_id, n=n)

    def handle_task_finished(self, key: Key = "", worker: str = "",
                             stimulus_id: str = "", **kwargs: Any) -> None:
        kwargs.pop("op", None)
        stimulus_id = stimulus_id or seq_name("task-finished")
        self._trace_ingress("task-finished", 1, stimulus_id)
        client_msgs, worker_msgs = self.state.stimulus_task_finished(
            key, worker, stimulus_id, **kwargs
        )
        self.send_all(client_msgs, worker_msgs)

    def handle_task_erred(self, key: Key = "", worker: str = "",
                          stimulus_id: str = "", exception: Any = None,
                          traceback: Any = None, **kwargs: Any) -> None:
        kwargs.pop("op", None)
        stimulus_id = stimulus_id or seq_name("task-erred")
        self._trace_ingress("task-erred", 1, stimulus_id)
        client_msgs, worker_msgs = self.state.stimulus_task_erred(
            key,
            worker,
            stimulus_id,
            # opaque: user exceptions may be classes this process cannot
            # import; they are stored and forwarded as-is, and the
            # worker-supplied exception_text covers scheduler-side logs
            exception=exception,
            traceback=traceback,
            **kwargs,
        )
        self.send_all(client_msgs, worker_msgs)

    def handle_tasks_finished(self, msgs: list, worker: str = "",
                              **kw: Any) -> None:
        """Batched ``task-finished`` flood: one state-machine pass, one
        staged send (rpc/core.py batch dispatch)."""
        finishes = []
        for m in msgs:
            key = m.pop("key", "")
            w = m.pop("worker", "") or worker
            stimulus_id = m.pop("stimulus_id", "") or seq_name("task-finished")
            finishes.append((key, w, stimulus_id, m))
        self._trace_ingress(
            "task-finished", len(finishes),
            finishes[0][2] if finishes else "",
        )
        client_msgs, worker_msgs = self.state.stimulus_tasks_finished_batch(
            finishes
        )
        self.send_all(client_msgs, worker_msgs)

    def handle_tasks_erred(self, msgs: list, worker: str = "",
                           **kw: Any) -> None:
        """Batched ``task-erred`` flood (a worker death mid-tile erring a
        whole co-assigned batch)."""
        errors = []
        for m in msgs:
            key = m.pop("key", "")
            w = m.pop("worker", "") or worker
            stimulus_id = m.pop("stimulus_id", "") or seq_name("task-erred")
            errors.append((key, w, stimulus_id, m))
        self._trace_ingress(
            "task-erred", len(errors), errors[0][2] if errors else ""
        )
        client_msgs, worker_msgs = self.state.stimulus_tasks_erred_batch(errors)
        self.send_all(client_msgs, worker_msgs)

    def handle_release_data_batch(self, msgs: list, worker: str = "",
                                  **kw: Any) -> None:
        """Batched ``release-worker-data`` flood (AMM drop rounds).  The
        generator interleaves replica removal with each key's transition
        round exactly like sequential per-message handling, while all
        rounds drain into one shared message pair."""
        state = self.state
        self._trace_ingress(
            "release-worker-data", len(msgs),
            (msgs[0].get("stimulus_id") or "") if msgs else "",
        )

        def rounds():
            for m in msgs:
                key = m.get("key", "")
                w = m.get("worker", "") or worker
                stimulus_id = m.get("stimulus_id") or seq_name("release-data")
                recs = state.stimulus_release_worker_data(key, w, stimulus_id)
                if recs:
                    yield (recs, stimulus_id)

        client_msgs, worker_msgs = state.transitions_batch(rounds())
        self.send_all(client_msgs, worker_msgs)

    def handle_release_data(self, key: Key = "", worker: str = "",
                            stimulus_id: str = "", **kwargs: Any) -> None:
        stimulus_id = stimulus_id or seq_name("release-data")
        self._trace_ingress("release-worker-data", 1, stimulus_id)
        recs = self.state.stimulus_release_worker_data(
            key, worker, stimulus_id
        )
        if recs:
            client_msgs, worker_msgs = self.state.transitions(
                recs, stimulus_id
            )
            self.send_all(client_msgs, worker_msgs)

    # the pure bodies of these scalar worker-op handlers live on
    # SchedulerState (stimulus_add_keys & co): the sans-io cluster
    # simulator (distributed_tpu_torch/sim) drives the same implementations
    # directly, so the live stream plane and the simulated one cannot
    # drift apart.

    def handle_add_keys(self, keys: Iterable[Key] = (), worker: str = "",
                        stimulus_id: str = "", **kwargs: Any) -> None:
        """Worker acquired replicas out-of-band (reference scheduler.py:5855)."""
        client_msgs, worker_msgs = self.state.stimulus_add_keys(
            keys, worker, stimulus_id or seq_name("add-keys")
        )
        self.send_all(client_msgs, worker_msgs)

    def handle_long_running(self, key: Key = "", worker: str = "",
                            compute_duration: float = 0.0,
                            stimulus_id: str = "", **kwargs: Any) -> None:
        """Task seceded from its thread slot (reference scheduler.py:5906)."""
        client_msgs, worker_msgs = self.state.stimulus_long_running(
            key, worker, compute_duration,
            stimulus_id or seq_name("long-running"),
        )
        self.send_all(client_msgs, worker_msgs)

    def handle_reschedule(self, key: Key = "", worker: str = "",
                          stimulus_id: str = "", **kwargs: Any) -> None:
        client_msgs, worker_msgs = self.state.stimulus_reschedule(
            key, worker, stimulus_id or seq_name("reschedule")
        )
        self.send_all(client_msgs, worker_msgs)

    def handle_missing_data(self, key: Key = "", errant_worker: str = "",
                            stimulus_id: str = "", **kwargs: Any) -> None:
        """A peer did not have data it was supposed to (reference :5869)."""
        client_msgs, worker_msgs = self.state.stimulus_missing_data(
            key, errant_worker, stimulus_id or seq_name("missing-data")
        )
        self.send_all(client_msgs, worker_msgs)

    def handle_request_refresh_who_has(self, keys: Iterable[Key] = (),
                                       worker: str = "",
                                       stimulus_id: str = "", **kw: Any) -> None:
        client_msgs, worker_msgs = self.state.stimulus_request_refresh_who_has(
            keys, worker, stimulus_id or seq_name("refresh-who-has")
        )
        self.send_all(client_msgs, worker_msgs)

    def handle_worker_log_event(self, topic: Any = None, msg: Any = None,
                                worker: str = "", **kw: Any) -> None:
        self.log_event(topic or "all", {"worker": worker, "msg": msg})

    def handle_worker_status_change(self, status: str = "", worker: str = "",
                                    stimulus_id: str = "",
                                    status_seq: int = -1, **kw: Any) -> None:
        # pure twin on SchedulerState (journals itself for the
        # durability tail; the sans-io simulator drives it directly)
        cm, wm = self.state.stimulus_worker_status_change(
            worker, status, status_seq,
            stimulus_id or seq_name("worker-status"),
        )
        self.send_all(cm, wm)

    # ------------------------------------------------------------- data ops

    async def gather(self, keys: Iterable[Key] = (), **kwargs: Any) -> dict:
        """Collect data from workers for a client (reference scheduler.py:6150)."""
        data: dict[Key, Any] = {}
        missing: set[Key] = set()
        busy: set[Key] = set()
        failed: list[str] = []
        pending: list[Key] = list(keys)
        for _attempt in range(3):
            who_has = {}
            for key in pending:
                ts = self.state.tasks.get(key)
                who_has[key] = [ws.address for ws in ts.who_has] if ts else []
            d, m, busy, f = await gather_from_workers(who_has, rpc=self.rpc)
            data.update(d)
            missing |= m
            failed.extend(w for w in f if w not in failed)
            if not busy:
                break
            # busy holders still HAVE the data: refresh who_has from
            # current state (the key may have gained replicas or moved)
            # and retry just those keys instead of reporting data that
            # exists as lost (ADVICE.md #1)
            logger.info("gather retrying %d busy key(s)", len(busy))
            pending = sorted(busy)
        if missing or busy:
            if missing:
                logger.warning("gather couldn't find %s", sorted(missing))
            if busy:
                logger.warning("gather gave up on busy holders of %s",
                               sorted(busy))
            return {
                "status": "error",
                "keys": sorted(missing | busy),
                "busy": sorted(busy),
                "workers": failed,
            }
        return {
            "status": "OK",
            # worker payloads are already opaque frames on this server:
            # forward without a deserialize/re-serialize round-trip
            "data": {k: wrap_opaque(v) for k, v in data.items()},
        }

    async def scatter(
        self,
        data: Any = None,
        client: str | None = None,
        workers: list[str] | None = None,
        broadcast: bool = False,
        timeout: float = 2.0,
        **kwargs: Any,
    ) -> list[Key]:
        """Place client data onto workers (reference scheduler.py:6103)."""
        # values stay opaque: forwarded to workers as the frames the
        # client sent; sizes come from the frames, not from unpickling
        data = dict(unwrap(data) or {})
        start = time()
        while not self.state.running:
            if time() - start > timeout:
                raise TimeoutError("no workers available for scatter")
            await asyncio.sleep(0.01)
        if workers:
            targets = [w for w in workers if w in self.state.workers]
        else:
            targets = sorted(ws.address for ws in self.state.running)
        who_has = await scatter_to_workers(targets, data, rpc=self.rpc)
        from distributed_tpu_torch.protocol.serialize import payload_nbytes

        stimulus_id = seq_name("scatter")
        for key, holders in who_has.items():
            # a holder may have left during scatter_to_workers: only live
            # workers count, and the memory transition needs a live one
            holders = [a for a in holders if a in self.state.workers]
            if not holders:
                logger.warning("scatter: all holders of %r left; data lost", key)
                continue
            # through the journaled engine twin (the sim drives the same
            # code): scattered data enters memory from no worker
            # stimulus, so a durable journal tail without these records
            # replays a cluster whose root partitions never existed
            cm, wm = self.state.stimulus_scatter_data(
                key, holders, payload_nbytes(data[key]), client,
                stimulus_id,
            )
            self.send_all(cm, wm)
        if broadcast:
            await self.replicate(keys=list(who_has), n=len(targets) if broadcast is True else broadcast)
        return list(who_has)

    async def replicate(self, keys: Iterable[Key] = (), n: int | None = None,
                        workers: list[str] | None = None, **kwargs: Any) -> None:
        """Copy keys onto additional workers (reference scheduler.py:6854)."""
        if workers:
            unknown = [w for w in workers if w not in self.state.workers]
            if len(unknown) == len(workers):
                # every requested target is unknown: error, don't
                # silently fan the data out to the whole cluster instead
                raise ValueError(
                    f"replicate: none of the requested workers are known: "
                    f"{sorted(workers)}"
                )
            if unknown:
                # partial typo: replicate to the known subset but say so
                # instead of silently dropping addresses
                logger.warning(
                    "replicate: ignoring unknown workers %s", sorted(unknown)
                )
        candidates = [
            self.state.workers[w] for w in (workers or [])
            if w in self.state.workers
        ] or list(self.state.running)
        if not candidates:
            return
        n = len(candidates) if n is None else n  # explicit 0 = no-op
        stimulus_id = seq_name("replicate")
        for key in keys:
            ts = self.state.tasks.get(key)
            if ts is None or not ts.who_has:
                continue
            need = min(n, len(candidates)) - len(ts.who_has)
            if need <= 0:
                continue
            holders = [ws.address for ws in ts.who_has]
            targets = [ws for ws in candidates if ws not in ts.who_has][:need]
            for ws in targets:
                self.send_all({}, {ws.address: [{
                    "op": "acquire-replicas",
                    "who_has": {key: holders},
                    "nbytes": {key: ts.nbytes},
                    "stimulus_id": stimulus_id,
                }]})

    # ---------------------------------------------------------- control ops

    async def stimulus_cancel(self, keys: Iterable[Key] = (), client: str = "",
                              force: bool = False, **kwargs: Any) -> None:
        """Client cancels futures (reference scheduler.py:5161)."""
        stimulus_id = seq_name("cancel")
        keys = list(keys)
        if keys:
            # one batched report, and for EVERY requested key (known or
            # not): the client registered a _cancel_expected entry per
            # key and consumes it on this confirmation
            self.report(
                {"op": "cancelled-keys", "keys": keys}, client=client
            )
        cancelled = [key for key in keys if key in self.state.tasks]
        client_msgs, worker_msgs = self.state.client_releases_keys(
            cancelled, client, stimulus_id
        )
        self.send_all(client_msgs, worker_msgs)

    async def stimulus_retry(self, keys: Iterable[Key] = (),
                             client: str | None = None, **kwargs: Any) -> list:
        client_msgs, worker_msgs = self.state.stimulus_retry(
            keys, seq_name("retry")
        )
        self.send_all(client_msgs, worker_msgs)
        return list(keys)

    async def restart(self, client: str = "", **kwargs: Any) -> str:
        """Forget all tasks; clear cluster state (reference scheduler.py:6193).

        The report carries the initiating client's id so that client can
        ignore its own echo (it cancels its futures synchronously)."""
        stimulus_id = seq_name("restart")
        self.stream_payload_flush()  # direct stream writes below
        for cs in list(self.state.clients.values()):
            if cs.client_key in self.client_comms:
                # snapshot THIS client's wanted keys: its echo cancels
                # exactly these — futures submitted after the restart was
                # processed here (but before the unordered echo reached
                # the client) must survive
                self.client_comms[cs.client_key].send(
                    {"op": "restart", "stimulus_id": stimulus_id,
                     "initiator": client,
                     "keys": [ts.key for ts in cs.wants_what]}
                )
        for addr in list(self.state.workers):
            self.send_all({}, {addr: [{"op": "free-keys",
                                       "keys": list(self.state.tasks),
                                       "stimulus_id": stimulus_id}]})
        self.state._clear_task_state()
        # workers under a nanny additionally CYCLE their process: the
        # reference's restart clears worker-side module/memory state too
        # (reference scheduler.py:6193 restart -> nanny.restart); bounded
        # best-effort — a dead nanny must not wedge the restart
        nannies = [
            ws.extra["nanny"]
            for ws in self.state.workers.values()
            if ws.extra.get("nanny")
        ]

        async def _cycle(addr: str) -> None:
            try:
                await asyncio.wait_for(self.rpc(addr).restart(), 10)
            except Exception:
                logger.warning("nanny %s did not restart its worker", addr)

        if nannies:
            await asyncio.gather(*(_cycle(a) for a in nannies),
                                 return_exceptions=True)
        return "OK"

    async def broadcast(self, msg: dict | None = None,
                        workers: list[str] | None = None,
                        hosts: list[str] | None = None,
                        nanny: bool = False, **kwargs: Any) -> dict:
        """Send an RPC to many workers, gather replies (reference :6331)."""
        msg = dict(unwrap(msg) or {})
        targets = workers if workers is not None else list(self.state.workers)
        if nanny:
            # route to the workers' nannies (reference scheduler.py:6331)
            targets = [
                ws.extra["nanny"]
                for a in targets
                if (ws := self.state.workers.get(a)) is not None
                and ws.extra.get("nanny")
            ]
        op = msg.pop("op")

        async def one(addr: str):
            try:
                return addr, await getattr(self.rpc(addr), op)(**msg)
            except Exception as e:
                return addr, error_message(e)

        results = await asyncio.gather(*(one(a) for a in targets))
        return dict(results)

    async def run_function_on_scheduler(self, function: Any = None,
                                        args: Any = None,
                                        kwargs: Any = None, **kw: Any) -> Any:
        from distributed_tpu_torch.rpc.core import run_user_function

        return await run_user_function(
            self, "dtpu_scheduler", function, args, kwargs, True
        )

    def adaptive_target(self, target_duration: float = 5.0) -> int:
        """Desired worker count to drain current load in ``target_duration``
        seconds (reference scheduler.py:8400).  Served over RPC so
        out-of-process clusters (Subprocess/SSH) can adapt."""
        import math

        s = self.state
        occupancy = sum(ws.occupancy for ws in s.workers.values())
        queued = len(s.queued) + len(s.unrunnable)
        avg_nthreads = (
            max(1, s.total_nthreads // max(1, len(s.workers)))
            if s.workers
            else 1
        )
        cpu = 0
        if occupancy > 0 or queued:
            cpu = math.ceil(
                (occupancy / target_duration + queued) / avg_nthreads
            )
        if s.unrunnable and not s.workers:
            cpu = max(1, cpu)
        return cpu

    async def retire_workers(self, workers: list[str] | None = None,
                             n: int | None = None, **kwargs: Any) -> list[str]:
        """Gracefully drain workers: replicate unique data away first
        (reference scheduler.py:7144, simplified)."""
        s = self.state
        if workers is None:
            if n is None:
                return []
            by_occ = sorted(s.workers.values(), key=lambda ws: ws.occupancy)
            workers = [ws.address for ws in by_occ[:n]]
        retired = []
        for addr in workers:
            ws = s.workers.get(addr)
            if ws is None:
                continue
            # move unique replicas to surviving workers
            survivors = [w for w in s.running if w.address != addr]
            if survivors:
                for ts in list(ws.has_what):
                    if len(ts.who_has) == 1:
                        # address tiebreak: survivors come from the
                        # ``running`` set, so equal nbytes must not fall
                        # back to hash-seed order
                        target = min(
                            survivors, key=lambda w: (w.nbytes, w.address)
                        )
                        resp = await self.rpc(target.address).gather(
                            who_has={ts.key: [addr]}
                        )
                        # re-validate after the await: while the transfer
                        # ran, the task may have been released/forgotten
                        # (a replica record would resurrect it as a
                        # phantom peers fetch forever) and the recipient
                        # may have left the cluster (found by the
                        # await-atomicity lint, rule 10)
                        if (
                            resp.get("status") == "OK"
                            and s.tasks.get(ts.key) is ts
                            and ts.state == "memory"
                            and s.workers.get(target.address) is target
                        ):
                            s.add_replica(ts, target)
            await self.remove_worker(addr, "retired", safe=True)
            retired.append(addr)
            # tell the worker process to shut down
            try:
                await self.rpc(addr).terminate()
            except (CommClosedError, OSError):
                pass
        return retired

    # ------------------------------------------------------------- queries

    async def get_who_has(self, keys: Iterable[Key] | None = None) -> dict:
        s = self.state
        if keys is None:
            keys = list(s.tasks)
        return {
            k: [ws.address for ws in s.tasks[k].who_has] if k in s.tasks else []
            for k in keys
        }

    async def get_has_what(self, workers: Iterable[str] | None = None) -> dict:
        s = self.state
        if workers is None:
            workers = list(s.workers)
        return {
            w: [ts.key for ts in s.workers[w].has_what] if w in s.workers else []
            for w in workers
        }

    async def get_ncores(self, workers: Iterable[str] | None = None) -> dict:
        s = self.state
        if workers is None:
            workers = list(s.workers)
        return {w: s.workers[w].nthreads for w in workers if w in s.workers}

    async def get_nbytes(self, keys: Iterable[Key] | None = None,
                         summary: bool = True) -> dict:
        s = self.state
        if keys is not None:
            return {k: s.tasks[k].nbytes for k in keys if k in s.tasks}
        return {k: ts.nbytes for k, ts in s.tasks.items() if ts.nbytes >= 0}

    async def get_processing(self, workers: Iterable[str] | None = None) -> dict:
        s = self.state
        if workers is None:
            workers = list(s.workers)
        return {
            w: [ts.key for ts in s.workers[w].processing]
            for w in workers if w in s.workers
        }

    async def get_missing_workers(self) -> list:
        return []

    # ---------------------------------------------------- plugins / state ops

    async def _send_plugin_to_worker(self, address: str, name: str,
                                     plugin: Any) -> None:
        try:
            await self.rpc(address).plugin_add(plugin=plugin, name=name)
        except (CommClosedError, OSError):
            pass

    async def register_scheduler_plugin(self, plugin: Any = None,
                                        name: str | None = None,
                                        idempotent: bool = False) -> str:
        """Install a live SchedulerPlugin (reference scheduler.py:5699)."""
        plugin = unwrap(plugin)
        name = name or getattr(plugin, "name", None) or f"plugin-{len(self.state.plugins)}"
        if idempotent and name in self.state.plugins:
            return "OK"
        start = getattr(plugin, "start", None)
        if start is not None:
            res = start(self)
            if asyncio.iscoroutine(res):
                await res
        self.state.plugins[name] = plugin
        return "OK"

    async def unregister_scheduler_plugin(self, name: str = "") -> str:
        plugin = self.state.plugins.pop(name, None)
        if plugin is not None:
            close = getattr(plugin, "close", None)
            if close is not None:
                res = close()
                if asyncio.iscoroutine(res):
                    await res
        return "OK"

    async def register_worker_plugin(self, plugin: Any = None,
                                     name: str | None = None) -> dict:
        """Install a WorkerPlugin on every current and future worker
        (reference scheduler.py:7425)."""
        if name is None:
            import itertools

            if not hasattr(self, "_plugin_counter"):
                self._plugin_counter = itertools.count()
            name = f"worker-plugin-{next(self._plugin_counter)}"
        # re-wrap: over tcp the comm already deserialized the plugin, and
        # it must cross the scheduler->worker wire pickled again
        plugin = Serialize(unwrap(plugin))
        self.worker_plugins[name] = plugin
        out = await self.broadcast(
            msg={"op": "plugin_add", "plugin": plugin, "name": name}
        )
        return out

    async def register_nanny_plugin(self, plugin: Any = None,
                                    name: str | None = None) -> dict:
        """Install a NannyPlugin on every current and future nanny
        (reference scheduler.py register_nanny_plugin)."""
        if name is None:
            name = f"nanny-plugin-{seq_name('np')}"
        plugin = wrap_opaque(plugin)
        self._nanny_plugins[name] = plugin
        return await self.broadcast(
            msg={"op": "plugin_add", "plugin": plugin, "name": name},
            nanny=True,
        )

    async def unregister_nanny_plugin(self, name: str = "") -> dict:
        self._nanny_plugins.pop(name, None)
        return await self.broadcast(
            msg={"op": "plugin_remove", "name": name}, nanny=True
        )

    async def _push_nanny_plugin(self, nanny_addr: str, name: str,
                                 plugin: Any) -> None:
        try:
            await self.rpc(nanny_addr).plugin_add(plugin=plugin, name=name)
        except Exception:
            logger.warning(
                "could not ship nanny plugin %r to %s", name, nanny_addr,
                exc_info=True,
            )

    async def unregister_worker_plugin(self, name: str = "") -> dict:
        self.worker_plugins.pop(name, None)
        return await self.broadcast(
            msg={"op": "plugin_remove", "name": name}
        )

    async def rebalance(self, keys: Iterable[Key] | None = None,
                        workers: list[str] | None = None, **kwargs: Any) -> dict:
        """Even out managed memory across workers (reference scheduler.py:6501).

        Two-phase like the reference: compute sender->recipient moves from
        the memory distribution (:6605), then enact them (:6795): the
        recipient gathers the key from the sender, then the sender drops
        its replica.
        """
        s = self.state
        mirror = s.mirror
        if mirror is not None and workers is None:
            # whole-fleet rebalance: the worker list and the projected-
            # memory vector come from the persistent mirror (slot-order
            # live list, O(dirty) refresh + one numpy gather) instead of
            # a per-call Python pack.  Explicit worker subsets (admin
            # RPC) keep the from-scratch path below.
            import numpy as np

            fv = mirror.fleet_view()
            wss = fv.live_list
            mem = fv.nbytes[fv.slots].astype(np.float32, copy=True)
        else:
            wss = [
                s.workers[w] for w in (workers or list(s.workers))
                if w in s.workers
            ]
            mem = None
            if mirror is not None:
                mirror.oracle_packs += 1
        if len(wss) < 2:
            return {"status": "OK", "moves": 0}
        keyset = set(keys) if keys is not None else None

        from distributed_tpu_torch.scheduler.gate import (
            config_gate,
            device_dispatch_worthwhile,
        )

        # gate on MOVABLE candidates, not raw key count (a keys=[...]
        # call or replicated data would otherwise dispatch the kernel
        # for a handful of items); the filter is O(keys) either way
        cand: list = []
        owner: list[int] = []
        for wi, ws in enumerate(wss):
            for ts in ws.has_what:
                if ts.actor or len(ts.who_has) != 1 or ts.state != "memory":
                    continue
                if keyset is not None and ts.key not in keyset:
                    continue
                cand.append(ts)
                owner.append(wi)
        if device_dispatch_worthwhile(len(wss), len(cand), min_items=512,
                                      periodic=True, **config_gate()):
            moves = self._rebalance_plan_device(wss, cand, owner, mem)
        else:
            moves = self._rebalance_plan_python(wss, keyset)

        # enact concurrently, one batched gather per (sender, recipient)
        # pair (reference _rebalance_move_data :6795 batches the same way)
        by_pair: dict[tuple, list] = {}
        for ts, sender, recipient in moves:
            if ts.state != "memory" or sender not in ts.who_has:
                continue
            by_pair.setdefault((sender, recipient), []).append(ts)

        async def move_batch(sender, recipient, tss) -> int:
            try:
                resp = await self.rpc(recipient.address).gather(
                    who_has={ts.key: [sender.address] for ts in tss}
                )
            except (CommClosedError, OSError):
                return 0
            if resp.get("status") != "OK":
                return 0
            for ts in tss:
                if recipient not in ts.who_has:
                    s.add_replica(ts, recipient)
            self.send_all({}, {sender.address: [{
                "op": "remove-replicas", "keys": [ts.key for ts in tss],
                "stimulus_id": seq_name("rebalance"),
            }]})
            return len(tss)

        counts = await asyncio.gather(
            *(move_batch(snd, rcp, tss) for (snd, rcp), tss in by_pair.items())
        )
        return {"status": "OK", "moves": sum(counts)}

    @staticmethod
    def _rebalance_plan_python(wss: list, keyset: set | None) -> list[tuple]:
        """Sequential greedy move selection (reference scheduler.py:6605):
        fullest senders shed their largest movable keys onto the emptiest
        recipients until everyone sits inside the 5% band."""
        mean = sum(ws.nbytes for ws in wss) / len(wss)
        senders = sorted(
            (ws for ws in wss if ws.nbytes > mean * 1.05),
            key=lambda ws: -ws.nbytes,
        )
        recipients = sorted(
            (ws for ws in wss if ws.nbytes < mean * 0.95),
            key=lambda ws: ws.nbytes,
        )
        moves: list[tuple] = []  # (ts, sender, recipient)
        projected = {ws: ws.nbytes for ws in wss}
        for sender in senders:
            for ts in sorted(sender.has_what, key=lambda t: -t.get_nbytes()):
                if projected[sender] <= mean:
                    break
                if keyset is not None and ts.key not in keyset:
                    continue
                if ts.actor or len(ts.who_has) != 1 or ts.state != "memory":
                    continue
                if not recipients:
                    break
                recipient = recipients[0]
                if projected[recipient] + ts.get_nbytes() > mean:
                    recipients.sort(key=lambda ws: projected[ws])
                    recipient = recipients[0]
                    if projected[recipient] + ts.get_nbytes() > mean * 1.05:
                        continue
                moves.append((ts, sender, recipient))
                projected[sender] -= ts.get_nbytes()
                projected[recipient] += ts.get_nbytes()
                recipients.sort(key=lambda ws: projected[ws])
        return moves

    def _rebalance_plan_device(
        self, wss: list, cand: list, owner: list[int], mem=None
    ) -> list[tuple]:
        """Vectorized move selection via the device kernel
        (ops/rebalance.py, K9 on ``state.device``): same invariants, Jacobi
        rounds instead of the sequential greedy loop.  ``mem`` is the
        mirror's projected-memory gather when available.  The path's
        counters are ``self.rebalance_path``'s; a failure raises."""
        from distributed_tpu_torch.scheduler.rebalance import RebalancePath

        if self.rebalance_path is None:
            self.rebalance_path = RebalancePath(self.state.device)
        return self.rebalance_path.plan_device(wss, cand, owner, mem)

    async def versions(self) -> dict:
        from distributed_tpu_torch.versions import get_versions

        return get_versions()

    async def worker_versions(self) -> dict:
        return {
            addr: ws.extra.get("versions", {})
            for addr, ws in self.state.workers.items()
        }

    async def benchmark_hardware(self) -> dict:
        """Memory/disk micro-benchmarks on workers (reference :7590)."""
        resp = await self.broadcast(msg={"op": "benchmark_hardware"})
        return {
            a: unwrap(v.get("result")) if isinstance(v, dict) else v
            for a, v in resp.items()
        }

    async def performance_report_html(self) -> str:
        """Self-contained HTML snapshot (reference scheduler.py:8077)."""
        import html as _html
        import json as _json

        s = self.state
        counts = self._counts_json()
        stream = self.task_stream.collect(count=2000)
        rows = "".join(
            f"<tr><td>{_html.escape(addr)}</td><td>{ws.nthreads}</td>"
            f"<td>{len(ws.has_what)}</td><td>{ws.nbytes}</td>"
            f"<td>{ws.occupancy:.2f}</td></tr>"
            for addr, ws in s.workers.items()
        )
        spans = [sp for sp in self.spans.spans.values() if len(sp.name) == 1]
        span_rows = "".join(
            f"<tr><td>{_html.escape('/'.join(sp.name))}</td>"
            f"<td>{sp.n_tasks}</td><td>{sp.compute_seconds:.3f}</td>"
            f"<td>{sp.nbytes}</td></tr>"
            for sp in spans
        )
        # per-activity fine metrics (reference metrics.py:159 ContextMeter
        # samples aggregated over heartbeats): seconds/bytes per
        # (context, activity-label) — execute, gather-dep network vs
        # deserialize vs other, spill serialize/disk-write/disk-read
        activities: dict[tuple[str, str, str], float] = {}
        for key, v in self.spans.cumulative_worker_metrics.items():
            # key = (context, span_id, prefix, label, unit)
            try:
                context, _sid, _pre, label, unit = key
            except Exception:
                continue
            k = (str(context), str(label), str(unit))
            activities[k] = activities.get(k, 0.0) + float(v)
        act_rows = "".join(
            f"<tr><td>{_html.escape(ctx)}</td><td>{_html.escape(label)}</td>"
            f"<td>{val:.3f}</td><td>{_html.escape(unit)}</td></tr>"
            for (ctx, label, unit), val in sorted(activities.items())
        )
        return f"""<!doctype html><html><head><meta charset="utf-8">
<title>distributed_tpu_torch performance report</title></head><body>
<h1>distributed_tpu_torch performance report</h1>
<h2>Cluster</h2>
<pre>{_html.escape(_json.dumps(counts, indent=1))}</pre>
<h2>Workers</h2>
<table border="1"><tr><th>address</th><th>threads</th><th>stored</th>
<th>bytes</th><th>occupancy</th></tr>{rows}</table>
<h2>Activities (fine metrics)</h2>
<table border="1"><tr><th>context</th><th>activity</th><th>total</th>
<th>unit</th></tr>{act_rows}</table>
<h2>Spans</h2>
<table border="1"><tr><th>span</th><th>tasks</th><th>compute s</th>
<th>bytes</th></tr>{span_rows}</table>
<h2>Task stream (last {len(stream)})</h2>
<pre>{_html.escape(_json.dumps(stream[-200:], indent=0, default=str))}</pre>
</body></html>"""

    async def get_runspec(self, key: Key = "") -> dict:
        """Fetch a task's spec + dependency keys for client-side replay
        (reference recreate_tasks.py ReplayTaskScheduler)."""
        ts = self.state.tasks.get(key)
        if ts is None:
            raise KeyError(key)
        return {
            "run_spec": wrap_opaque(ts.run_spec),
            "deps": [d.key for d in ts.dependencies],
        }

    async def get_telemetry(self) -> list[dict]:
        """The fleet telemetry snapshot (JSON-safe records): the RPC
        twin of the HTTP ``/telemetry`` route (telemetry.py)."""
        return self.state.telemetry.snapshot()

    async def get_ledger(self, n: int | None = None) -> list[dict]:
        """The decision–outcome ledger (summary head + resident row
        tail): the RPC twin of the HTTP ``/ledger`` route (ledger.py;
        docs/observability.md "Decision ledger & critical-path")."""
        return self.state.ledger.snapshot(n)

    async def get_census(self, deep: bool = False) -> list[dict]:
        """The state census (head + per-family records + recent
        findings): the RPC twin of the HTTP ``/census`` route
        (diagnostics/census.py; docs/observability.md "State census &
        retention").  ``deep=True`` adds the O(n) walk families — the
        relation-set edge counts — and is meant for quiesced or
        dump-time use, not a per-second poll."""
        return self.state.census.snapshot(deep=deep)

    async def get_cluster_state(self, exclude: list[str] | None = None) -> dict:
        """Debug dump of the whole cluster (reference scheduler.py:3964)."""
        s = self.state
        scheduler_info = {
            "address": self.address,
            "id": self.id,
            "tasks": {
                k: {
                    "state": ts.state,
                    "priority": ts.priority,
                    "who_has": [ws.address for ws in ts.who_has],
                    "processing_on": (
                        ts.processing_on.address if ts.processing_on else None
                    ),
                    "nbytes": ts.nbytes,
                    "dependencies": [d.key for d in ts.dependencies],
                }
                for k, ts in s.tasks.items()
            },
            "workers": {
                addr: {
                    "name": str(ws.name),
                    "nthreads": ws.nthreads,
                    "nbytes": ws.nbytes,
                    "status": str(ws.status),
                    "processing": [ts.key for ts in ws.processing],
                    "has_what": [ts.key for ts in ws.has_what],
                }
                for addr, ws in s.workers.items()
            },
            "clients": {c: [ts.key for ts in cs.wants_what]
                        for c, cs in s.clients.items()},
            "events": {t: len(evs) for t, evs in s.events.items()},
            "transition_log_length": len(s.transition_log),
        }
        if "telemetry" not in (exclude or ()):
            # the measured-truth snapshot travels with the dump: a
            # post-mortem can see which links/priors the cost model was
            # lying about without a live cluster (telemetry.py)
            scheduler_info["telemetry"] = self.state.telemetry.snapshot()
        if "ledger" not in (exclude or ()):
            # decision–outcome ledger tail + a PRECOMPUTED critical-path
            # summary (ledger.py, diagnostics/critical_path.py): the
            # dump's task table still holds the dependency map here, so
            # the path is computed while the graph is known — the
            # offline DumpArtefact.critical_path() recomputes it from
            # the same two sections
            ledger_info: dict[str, Any] = {
                "rows": s.ledger.tail(500),
                "summary": s.ledger.summary(),
            }
            try:
                from distributed_tpu_torch.diagnostics.critical_path import (
                    critical_path,
                )

                cp = critical_path(
                    ledger_info["rows"],
                    {
                        k: [d.key for d in ts.dependencies]
                        for k, ts in s.tasks.items()
                    },
                )
                if cp is not None:
                    ledger_info["critical_path"] = {
                        "makespan": cp["makespan"],
                        "n_tasks": cp["n_tasks"],
                        "terminal": cp["terminal"],
                        "attribution": cp["attribution"],
                        "by_prefix": cp["by_prefix"],
                    }
            except Exception:
                logger.exception("critical-path precompute failed")
            scheduler_info["ledger"] = ledger_info
        if "transition_log" not in (exclude or ()):
            # the newest transition rows travel WITH the dump so a
            # post-mortem can replay a task's story offline
            # (diagnostics/cluster_dump.DumpArtefact.story; reference
            # cluster_dump.py:111); exclude=['transition_log'] keeps
            # periodic snapshots cheap
            scheduler_info["transition_log"] = [
                list(row) for row in list(s.transition_log)[-5000:]
            ]
        if "profile" not in (exclude or ()):
            # the self-profile tail travels with the dump: a postmortem
            # can see where the scheduler's wall went (phase budget),
            # the sampled control-plane tree, and any stall captures —
            # without a live cluster (docs/observability.md)
            prof: dict[str, Any] = {
                "wall_seconds": {
                    k: round(v, 6) for k, v in s.wall.snapshot().items()
                },
            }
            if self.cp_profiler is not None:
                prof["samples_total"] = self.cp_profiler.total_samples
                prof["idle_samples"] = self.cp_profiler.idle_samples
                prof["tree"] = self.cp_profiler.get_profile()
            if self.watchdog is not None:
                prof["stalls_total"] = self.watchdog.stalls_total
                prof["stalls"] = list(self.watchdog.stalls)
            scheduler_info["profile"] = prof
        if "census" not in (exclude or ()):
            # the state census travels with the dump (deep = relation
            # walks included): a post-mortem can see exactly what the
            # control plane was still holding, with any recorded
            # retention findings (diagnostics/census.py)
            scheduler_info["census"] = s.census.snapshot(deep=True)
        out = {"scheduler": scheduler_info}
        if "census" not in (exclude or ()):
            out["worker_census"] = await self.broadcast(
                msg={"op": "get_census", "deep": True}
            )
        if "flight_recorder" not in (exclude or ()):
            # every node's causal tail ships in the dump by default
            # (bounded, JSON-safe): chaos post-mortems can join the
            # scheduler's ingress/engine/egress hops against each
            # worker's stimulus events without a live cluster.  The two
            # cluster-wide broadcasts are independent: gather them.
            scheduler_info["flight_recorder"] = self.trace.tail(500)
            out["worker_traces"], out["workers"] = await asyncio.gather(
                self.broadcast(msg={"op": "get_trace", "n": 200}),
                self.broadcast(msg={"op": "identity"}),
            )
        else:
            out["workers"] = await self.broadcast(msg={"op": "identity"})
        return out

    def _counts_json(self) -> dict:
        s = self.state
        by_state: dict[str, int] = {}
        for ts in s.tasks.values():
            by_state[ts.state] = by_state.get(ts.state, 0) + 1
        return {
            "tasks": len(s.tasks),
            "states": by_state,
            "workers": len(s.workers),
            "clients": len(s.clients),
            "queued": len(s.queued),
            "unrunnable": len(s.unrunnable),
        }

    async def log_event_handler(self, topic: Any = None, msg: Any = None) -> None:
        self.log_event(topic or "all", msg)

    def log_event(self, topic: Any, msg: Any) -> None:
        """Record + fan out to subscribed clients (reference scheduler.py:8244)."""
        self.state.log_event(topic, msg)

    def _fan_out_event(self, topics: list, msg: Any) -> None:
        for t in topics:
            for client in self._topic_subscribers.get(t, ()):
                self.report(
                    {"op": "event", "topic": t, "msg": msg}, client=client
                )

    def subscribe_topic(self, topic: str = "", client: str = "", **kw: Any) -> None:
        self._topic_subscribers.setdefault(topic, set()).add(client)

    def unsubscribe_topic(self, topic: str = "", client: str = "", **kw: Any) -> None:
        self._topic_subscribers.get(topic, set()).discard(client)

    def handle_client_log_event(self, topic: Any = None, msg: Any = None,
                                client: str = "", **kw: Any) -> None:
        self.log_event(topic or "all", msg)

    async def get_task_stream(self, start: float | None = None,
                              count: int | None = None) -> list:
        return self.task_stream.collect(start=start, count=count)

    async def get_profile(self, workers: list[str] | None = None,
                          start: float | None = None,
                          scope: str = "all") -> Any:
        """Merged profiles (reference scheduler.py:7991), with the
        scheduler's own control-plane tree in the merge.

        ``scope``: ``"workers"`` — executor trees from the fleet only
        (the pre-self-profiling behavior); ``"scheduler"`` — this
        process's control-plane tree only (no broadcast); ``"all"``
        (default) — both merged."""
        from distributed_tpu_torch.diagnostics.profile import merge
        from distributed_tpu_torch.protocol.serialize import unwrap

        if scope not in ("workers", "scheduler", "all"):
            raise ValueError(f"unknown profile scope {scope!r}")
        trees = []
        if scope in ("workers", "all"):
            resp = await self.broadcast(
                msg={"op": "profile", "start": start}, workers=workers
            )
            for v in resp.values():
                v = unwrap(v)
                if isinstance(v, dict) and "count" in v:
                    trees.append(v)
        if scope in ("scheduler", "all") and self.cp_profiler is not None:
            trees.append(self.cp_profiler.get_profile(start=start))
        return merge(*trees)

    async def get_events_handler(self, topic: str | None = None) -> Any:
        if topic is not None:
            return list(self.state.events.get(topic, ()))
        return {t: list(evs) for t, evs in self.state.events.items()}

    @property
    def dashboard_address(self) -> str | None:
        """http://host:port of the live dashboard, None before start.

        The host comes from the scheduler's ADVERTISED address, not the
        HTTP bind host: the latter defaults to 127.0.0.1, which would
        hand remote clients a link to their own loopback."""
        http = getattr(self, "http_server", None)
        if http is None:
            return None
        try:
            port = http.port
        except Exception:  # pragma: no cover - server not listening yet
            return None
        host = http.host
        try:
            from distributed_tpu_torch.comm.addressing import parse_host_port

            adv = parse_host_port(self.address.split("://", 1)[-1])[0]
            if adv and adv not in ("0.0.0.0", ""):
                host = adv
        # graft-lint: allow[swallowed-exceptions] inproc:// has no host:port; keep the bind host
        except Exception:
            pass
        return f"http://{host}:{port}"

    def get_computations(self) -> list[dict]:
        """Recent update_graph batches, newest last (reference
        Scheduler.computations, scheduler.py:864)."""
        return [
            {
                "id": comp.id,
                "start": comp.start,
                "stop": comp.stop,
                "groups": sorted(tg.name for tg in comp.groups),
                "states": comp.states,
            }
            for comp in self.state.computations
        ]

    def eventstream_start(self, client: str = "") -> str:
        """Install the opt-in per-task event publisher (reference
        diagnostics/eventstream.py:12); consumers subscribe to the
        returned topic.  Opt-in because it costs a ring-buffer append
        plus subscriber fan-out on EVERY task completion.  Refcounted:
        the plugin is global, so one consumer's stop must not kill the
        stream for the others.  Passing ``client`` ties the reference to
        that client's lifetime — released automatically when the client
        disconnects (anonymous references require an explicit stop)."""
        from distributed_tpu_torch.diagnostics.eventstream import EventStreamPlugin

        self._eventstream_refs += 1
        if client:
            self._eventstream_clients[client] = (
                self._eventstream_clients.get(client, 0) + 1
            )
        else:
            self._eventstream_anon += 1
        if EventStreamPlugin.name not in self.state.plugins:
            EventStreamPlugin(self)
        return EventStreamPlugin.topic

    def eventstream_stop(self, client: str = "") -> None:
        # an unmatched/double stop (tied OR anonymous) must not steal a
        # reference another live consumer still holds
        if client:
            held = self._eventstream_clients.get(client, 0)
            if not held:
                return
            if held == 1:
                del self._eventstream_clients[client]
            else:
                self._eventstream_clients[client] = held - 1
        else:
            if not self._eventstream_anon:
                return
            self._eventstream_anon -= 1
        self._release_eventstream_refs(1)

    def _release_eventstream_refs(self, n: int) -> None:
        from distributed_tpu_torch.diagnostics.eventstream import EventStreamPlugin

        self._eventstream_refs = max(self._eventstream_refs - n, 0)
        if not self._eventstream_refs:
            self.state.plugins.pop(EventStreamPlugin.name, None)

    async def identity(self) -> dict:
        """Cluster snapshot; shape documented by
        ``utils.objects.SchedulerInfo`` (reference objects.py)."""
        return {
            "type": type(self).__name__,
            "id": self.id,
            "address": self.address,
            "dashboard": self.dashboard_address,
            "workers": {
                addr: {
                    "name": ws.name,
                    "nthreads": ws.nthreads,
                    "memory_limit": ws.memory_limit,
                    "status": str(getattr(ws, "status", "running")),
                }
                for addr, ws in self.state.workers.items()
            },
        }

    def __repr__(self) -> str:
        try:
            addr = self.address
        except ValueError:
            addr = "not-listening"
        return (
            f"<Scheduler {addr!r} workers={len(self.state.workers)} "
            f"tasks={len(self.state.tasks)}>"
        )


def _coalesce_worker_stream_msgs(msgs: list[dict]) -> list[dict]:
    """Fold consecutive same-op runs bound for one worker into batch
    messages: N ``compute-task`` dicts become one ``compute-tasks``
    envelope (each inner message keeps its own stimulus_id — causal
    stories survive), and adjacent ``free-keys`` with the SAME
    stimulus_id merge their key lists.  Only consecutive runs merge, so
    cross-op ordering (a free-keys fencing a later compute-task of the
    same key) is preserved exactly.  Never mutates input messages: the
    state machine shares message dicts across destinations."""
    if len(msgs) < 2:
        return msgs
    out: list[dict] = []
    for m in msgs:
        prev = out[-1] if out else None
        op = m.get("op")
        if op == "compute-task" and prev is not None:
            if prev.get("op") == "compute-tasks":
                prev["tasks"].append(m)
                continue
            if prev.get("op") == "compute-task":
                out[-1] = {"op": "compute-tasks", "tasks": [prev, m]}
                continue
        elif (
            op == "free-keys"
            and prev is not None
            and prev.get("op") == "free-keys"
            and prev.get("stimulus_id") == m.get("stimulus_id")
        ):
            out[-1] = {
                **prev,
                "keys": list(prev["keys"]) + list(m["keys"]),
            }
            continue
        out.append(m)
    return out
