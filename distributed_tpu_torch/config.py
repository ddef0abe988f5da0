"""Layered configuration tree.

The port's copy of ``distributed_tpu/config.py``.  It keeps every key
name of the reference, ``scheduler.jax.*`` included, so one override dict
drives both packages; in the port those keys configure the torch
co-processor on the card.  What differs:

- the reference's ``~/.config/distributed_tpu/*.yaml`` files (or the
  ``DTPU_CONFIG`` directory) are read with PyYAML where it is installed,
  and a file that cannot be read raises (the reference skips it quietly;
  the card's machine has no PyYAML, so there such a file always raises);
- ``scheduler.native-engine.enabled`` defaults to False: the native
  transition engine is not in the port yet
  (``SchedulerState.attach_native`` raises).

Equivalent of the reference's ``dask.config`` + ``distributed/distributed.yaml``
(the reference's ``config.py`` and ``distributed.yaml``): packaged
defaults, overridable by ``~/.config/distributed_tpu/*.yaml`` files and
``DTPU_*`` environment variables (dot-path munged, ``__`` -> ``.``), with
dot-path ``get``/``set`` accessors and a context-manager override.

Hot-path consumers cache values at init time (as the reference caches
UNKNOWN_TASK_DURATION etc. in SchedulerState.__init__, scheduler.py:1756) so
config lookups never appear in inner loops.
"""

from __future__ import annotations

import ast
import os
import threading
from collections.abc import Mapping
from contextlib import contextmanager
from typing import Any

# ---------------------------------------------------------------------------
# Packaged defaults.  Mirrors the semantics of the reference's
# distributed.yaml (350 lines) — same knob names where the concept carries
# over, new ``scheduler.jax`` subtree for the TPU co-processor.
# ---------------------------------------------------------------------------
defaults: dict[str, Any] = {
    "scheduler": {
        "allowed-failures": 3,          # reference distributed.yaml:12
        "bandwidth": 100_000_000,       # bytes/s cost-model constant (yaml:13)
        # fixed cost charged per MISSING dependency on a candidate worker,
        # on top of bytes/bandwidth: every fetch pays an RPC round trip
        # (serialize, two loop handlings, deserialize) no matter how tiny
        # the payload.  bytes/bandwidth alone makes transfers of small
        # chunks look free, so the objective scatters reduction trees
        # across workers and the cluster drowns in gather_dep chatter.
        # The reference has no such term (its worker_objective is pure
        # bytes/bandwidth, reference scheduler.py:3131).
        "transfer-latency": "500us",
        "blocked-handlers": [],
        "preload": [],
        "preload-argv": [],
        "default-task-durations": {"rechunk-split": "1us", "split-shuffle": "1us"},
        "idle-timeout": None,
        "no-workers-timeout": None,
        "work-stealing": True,
        "work-stealing-interval": "100ms",
        # skip the steal confirm round trip for tasks deep in a big
        # victim backlog (>=4x nthreads): the victim gets free-keys and
        # the thief is dispatched immediately.  A wrong guess (task
        # already executing) wastes one execution but is always correct
        # (stale completions are fenced by processing_on).  Off by
        # default: the confirm protocol is the reference-proven path.
        "work-stealing-speculative": False,
        "worker-saturation": 1.1,       # queuing threshold (yaml:24)
        "worker-ttl": "5 minutes",
        "unknown-task-duration": "500ms",
        "validate": False,
        "transition-log-length": 100_000,
        "events-log-length": 100_000,
        "jax": {                        # the TPU co-processor (north star)
            "enabled": True,            # use device kernels when available
            "min-batch": 512,           # below this, pure-python path is faster
            "min-workers": 8,           # below this the O(deps) python
                                        # oracle wins; the partitioner
                                        # planner pays from ~8 workers on
                                        # transfer-heavy graphs (measured
                                        # 17-30% wall at 16 workers)
            # separate floor for the PERIODIC device kernels (stealing,
            # AMM, rebalance): these dispatch on the event loop every
            # cycle, so lowering min-workers to study placement hints
            # must not drag a per-tick jax dispatch into small clusters
            "periodic-min-workers": 48,
            "sync-plan": False,         # plan on-loop (deterministic tests)
            # graph-partitioner engine for the placement plan:
            # auto  = jitted kernel, numpy fallback on failure
            # numpy = skip jax entirely (no-device hosts, tests)
            # off   = always use the leveled wave placer
            "partitioner": "auto",
            # home-stack depth for plan hints, in worker-thread units
            # beyond the open-slot line: a hinted task lands directly on
            # its busy home while fewer than
            #   ceil(nthreads*saturation) + home-depth*nthreads
            # tasks are processing there (worker-side queue, no extra
            # scheduler transitions); beyond that it parks scheduler-side
            # for the home's next slot-open. "inf" = never park.
            "home-depth": "inf",
            # allow the backlog-outlier check to yield a hinted task to
            # an idle worker when its home has fallen far behind.  Off =
            # trust the plan absolutely (uniform fleets; drift is then
            # handled only by pause/death splicing)
            "drift-yield": True,
            # skip graph planning when mean transfer cost is below this
            # fraction of mean task duration (locality can't pay there);
            # 0 disables the gate
            "min-transfer-ratio": 0.02,
            "capacity-doubling": True,  # grow SoA arrays by 2x
            # persistent fleet SoA mirror (scheduler/mirror.py): delta-
            # maintained per-worker arrays shared by every co-processor
            # kernel; off = every cycle rebuilds its snapshot from
            # scratch (the oracle pack).  DTPU_MIRROR_CHECK=1 verifies
            # the mirror against that oracle on every view.
            "mirror": True,
            # device-mesh sharding of the placement engine + fleet
            # mirror (ops/leveled.place_graph_leveled_sharded,
            # scheduler/mirror.sharded_device_view): one placement
            # cycle runs as a single partitioned XLA program over N
            # devices.  "auto" (default) turns it on iff more than one
            # device is visible at mesh-build time — a one-device host
            # pays pure collective overhead and keeps the single-device
            # -> python fallback chain; explicit true/false force it.
            "mesh": {
                "enabled": "auto",
                # devices to put in the mesh; 0 = all visible
                "devices": 0,
                # "auto" (near-square factoring, workers axis the
                # smaller factor) or an explicit "TxW" layout, e.g.
                # "4x2" (tasks x workers)
                "layout": "auto",
            },
        },
        # flight recorder (tracing.py; docs/observability.md): always-on
        # bounded ring of causal control-loop events.  Shared by both
        # roles — the worker's state machine reads the same subtree.
        "trace": {
            "enabled": True,
            "ring-size": 16384,       # events resident per recorder
            # 1-in-N sampling for TASK-LEVEL events (per-transition /
            # per-worker-stimulus); batch-level events are never sampled
            "sample": 1,
            # record mode: capture the replayable stimulus journal
            # (per-event dict build — off the always-on budget)
            "journal": False,
            "journal-size": 65536,    # stimulus records kept in record mode
        },
        # state census + retention sentinel (diagnostics/census.py;
        # docs/observability.md "State census & retention").  Shared by
        # both roles like the trace subtree; `enabled` gates only the
        # periodic sentinel tick — the census registry itself is always
        # built (the registration-completeness gate depends on it).
        "census": {
            "enabled": True,
            "interval": "2s",         # sentinel tick cadence
            # sustained growth (members/second EWMA) beyond this flags
            # a family as leaking (one flight-recorder `leak` event per
            # episode)
            "slope-threshold": 50.0,
            # families below this resident count never flag (noise
            # floor: a bounded warm-up is not a leak)
            "min-count": 1000,
        },
        # control-plane self-profiling (diagnostics/selfprofile.py;
        # docs/observability.md "Self-profiling").  Shared by both
        # roles, like the trace subtree: the worker's event loop reads
        # the same knobs.
        "profile": {
            "enabled": True,
            "interval": "20ms",       # control-plane sampling rate
            "cycle": "1s",            # profile-tree rollover
            "history": 60,            # cycles kept per profiler
            # frame boundary: sampled stacks are cut at the asyncio
            # dispatch machinery so the shared run_forever prefix (and
            # an idle loop's selector frames) don't swamp the tree
            "stop": "asyncio/base_events.py",
            # loop lag beyond this triggers a stall capture (traceback
            # of the blocked loop thread into the flight recorder)
            "stall-threshold": "1s",
            "watchdog-interval": "100ms",
            # exact per-transition-arm wall accumulators
            # (engine.scalar-arm:<start>,<finish>): the sim.profile_run
            # payoff artifact turns this on; off by default because two
            # monotonic reads per transition are NOT free on the flood
            # path (the <5% smoke gate covers the default config)
            "arm-attribution": False,
        },
        # measured-truth telemetry plane (telemetry.py;
        # docs/observability.md): per-link transfer EWMAs/t-digests,
        # task-prefix priors, and the shadow cost-model divergence
        # monitor.  Read-only: decisions still use the constants above
        # (ROADMAP item 3 swaps the inputs in a future PR).
        "telemetry": {
            "enabled": True,
            "ewma-alpha": 0.25,       # per-sample EWMA decay
            # 1-in-N sampling of shadow cost evaluations (placement +
            # steal pricing); the divergence histogram observes only
            # sampled evals
            "divergence-sample": 1,
        },
        # decision–outcome ledger (ledger.py; docs/observability.md
        # "Decision ledger & critical-path"): every placement/steal/AMM
        # decision files a bounded row joined to its realized outcome —
        # the regret signal ROADMAP item 1's payoff gates calibrate on.
        "ledger": {
            "enabled": True,
            "size": 16384,   # rows resident (rounded up to a power of two)
        },
        # native (C++) transition engine for the four dominant scheduler
        # arms (scheduler/native_engine.py; docs/native_engine.md).
        # Degrades to the pure-python oracle when the toolchain is
        # missing or DTPU_NATIVE_DISABLE is set; DTPU_NATIVE_CHECK runs
        # the per-flood SoA<->python parity audit.
        "native-engine": {
            "enabled": False,
            # floods below this many events run the pure-python oracle.
            # Default 0 (native whenever attached): the SoA maintenance
            # hooks are paid regardless, so routing small floods to the
            # oracle only helps when the knob is paired with an
            # (unattached) engine — measured 0.78x at min-flood=12 vs
            # 1.11x at 0 on the 1000-worker sim (PERF.md Round 11).
            "min-flood": 0,
        },
        "active-memory-manager": {
            "start": True,
            "interval": "2s",
            "policies": [{"class": "distributed_tpu_torch.scheduler.amm.ReduceReplicas"}],
        },
        # scheduler durability (scheduler/durability.py;
        # docs/durability.md): periodic incremental SchedulerState
        # snapshots + an append-only journal-segment tail, so a
        # scheduler bounce restarts from snapshot + tail replay instead
        # of total state loss.  Off unless ``directory`` is set.
        "durability": {
            "directory": None,          # durable sink dir; None = off
            "snapshot-interval": "5s",  # incremental snapshot cadence
            "flush-interval": "1s",     # journal segment flush cadence
            "full-every": 16,           # base snapshot every N epochs
            # bounded re-registration window after a restore: workers
            # from the snapshot that have not re-registered when it
            # expires are removed and their tasks rescheduled
            "grace": "15s",
        },
    },
    "worker": {
        "blocked-handlers": [],
        "transfer": {
            "message-bytes-limit": "50MB",   # yaml:89
        },
        # run a task INLINE on the event loop (no executor round trip)
        # when its prefix's measured in-thread duration EMA is below
        # this; at most ~5ms of inline work per 20ms window so the loop
        # never starves.  "0" disables — the default: on a single-core
        # host the executor handoff is nearly free (GIL interleaving)
        # while inlining blocks the loop's comm multiplexing (measured
        # +9% wall on the tensordot bench).  Worth enabling on real
        # multi-core workers with sub-100us task storms.
        # (No reference equivalent: dask always offloads, worker.py:2210.)
        "inline-threshold": "0",
        # issue up to this many EXTRA Executes beyond nthreads for tasks
        # whose duration estimate is under execute-pipeline-threshold;
        # the worker runs each such instruction batch as ONE executor
        # submission (one thread handoff + one completion wakeup per
        # batch).  Tiny-task storms are wakeup-bound: on the config-2
        # bench the loop thread burned ~87% of process CPU, much of it
        # self-pipe/epoll churn from per-task executor round trips.
        "execute-pipeline": 16,
        "execute-pipeline-threshold": "5ms",
        "connections": {"outgoing": 50, "incoming": 10},
        # registration handshake retry/backoff (worker/server.py): a
        # register-worker RPC that times out retries with exponential
        # backoff + seeded jitter; the scheduler side is idempotent per
        # server_id, so a retry after a half-applied registration never
        # double-counts replicas or occupancy
        "register": {"retries": 3, "base-delay": "100ms", "max-delay": "2s"},
        # scheduler-stream reconnect (scheduler bounce survival): when
        # > 0, a worker whose scheduler stream dies re-registers with
        # backoff for up to this many attempts — carrying its held data
        # keys so the restarted scheduler's recovery window can rebuild
        # who_has — instead of closing.  0 keeps the historical
        # behavior: stream loss closes the worker (nanny restarts it).
        "reconnect-attempts": 0,
        "preload": [],
        "preload-argv": [],
        "validate": False,
        "resources": {},
        "lifetime": {"duration": None, "stagger": "0 seconds", "restart": False},
        "profile": {"enabled": True, "interval": "10ms", "cycle": "1000ms", "low-level": False},
        "memory": {
            "recent-to-old-time": "30s",
            "rebalance": {
                "measure": "optimistic",
                "sender-min": 0.30,
                "recipient-max": 0.60,
                "sender-recipient-gap": 0.10,
            },
            "transfer": 0.10,
            "target": 0.60,     # spill by managed memory (yaml:155)
            "spill": 0.70,      # spill by process memory
            "pause": 0.80,
            "terminate": 0.95,
            "max-spill": False,
            "spill-compression": "auto",
            "monitor-interval": "100ms",
        },
    },
    "shuffle": {                         # P2P shuffle engine storage layer
        "disk": True,                    # spill received shards to disk
        "memory-limit": "128MiB",        # backpressure threshold for buffered shards
        "comm-message-bytes": "2MiB",    # outbound shard batch size per peer
        "run-ttl": "300s",               # forget idle runs after this long
        "max-restarts": 5,               # epoch restarts before the shuffle errs
        "restart-debounce": "50ms",      # coalescing window for restart causes
    },
    "nanny": {
        "blocked-handlers": [],
        "preload": [],
        "preload-argv": [],
        "environ": {},
        "pre-spawn-environ": {
            "OMP_NUM_THREADS": 1,
            "MKL_NUM_THREADS": 1,
            "OPENBLAS_NUM_THREADS": 1,
        },
    },
    "client": {
        "heartbeat": "5s",
        "preload": [],
        "preload-argv": [],
    },
    "adaptive": {
        "interval": "1s",
        "target-duration": "5s",
        "minimum": 0,
        "maximum": float("inf"),
        "wait-count": 3,
    },
    "comm": {
        "retry": {"count": 0, "delay": {"min": "1s", "max": "20s"}},
        "compression": False,            # yaml: compression false by default
        # zstd codec tuning, honored when the optional `zstandard`
        # package is present (protocol/compression.py)
        "zstd": {"level": 3, "threads": 0},
        "shard": "64MiB",
        # hard cap on one wire message (frame-lengths sum): a corrupt or
        # hostile header must not trigger an arbitrary-size allocation
        "max-message-bytes": "2GiB",
        # total bytes the zero-copy receive pool may keep cached
        # (protocol/buffers.py BufferPool; docs/wire.md)
        "receive-pool-bytes": "64MiB",
        "default-scheme": "tcp",
        "socket-backlog": 2048,
        "timeouts": {"connect": "30s"},
        "require-encryption": None,
        "tls": {"ciphers": None, "min-version": 1.2, "ca-file": None,
                "scheduler": {"cert": None, "key": None},
                "worker": {"cert": None, "key": None},
                "client": {"cert": None, "key": None}},
    },
    "diagnostics": {
        "computations": {"max-history": 100},
    },
    "admin": {
        # map() pickles the function once per task (specs are opaque
        # per-task leaves): flag closures that make that expensive
        "large-function-warning-bytes": "1MiB",
        "max-error-length": 10_000,
        "system-monitor": {"interval": "500ms", "log-length": 7200},
    },
}

_lock = threading.Lock()
_config: dict[str, Any] = {}


def _deep_update(dst: dict, src: Mapping) -> dict:
    for k, v in src.items():
        if isinstance(v, Mapping) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = v if not isinstance(v, Mapping) else dict(v)
    return dst


def _deep_copy(d: Any) -> Any:
    if isinstance(d, Mapping):
        return {k: _deep_copy(v) for k, v in d.items()}
    if isinstance(d, list):
        return [_deep_copy(v) for v in d]
    return d


def refresh() -> None:
    """Rebuild the config from defaults + user yaml + environment."""
    global _config
    cfg = _deep_copy(defaults)
    # user yaml files: one that cannot be read raises
    confdir = os.environ.get(
        "DTPU_CONFIG", os.path.expanduser("~/.config/distributed_tpu")
    )
    if os.path.isdir(confdir):
        for fn in sorted(os.listdir(confdir)):
            if fn.endswith((".yaml", ".yml")):
                _deep_update(cfg, _read_yaml(os.path.join(confdir, fn)))
    # environment: DTPU_SCHEDULER__WORK_STEALING=False -> scheduler.work-stealing
    for name, value in os.environ.items():
        if not name.startswith("DTPU_") or name == "DTPU_CONFIG":
            continue
        path = name[len("DTPU_"):].lower().replace("__", ".").replace("_", "-")
        try:
            parsed: Any = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            parsed = value
        _set_path(cfg, path, parsed)
    with _lock:
        _config = cfg


def _read_yaml(path: str) -> dict:
    """One user configuration file; raises when it cannot be read."""
    try:
        import yaml  # type: ignore
    except ImportError as exc:
        raise RuntimeError(
            f"configuration file {path}: PyYAML is not installed, so the port "
            "cannot read it; set the keys through DTPU_* environment "
            "variables or config.set instead"
        ) from exc
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    if not isinstance(data, Mapping):
        raise RuntimeError(f"configuration file {path}: not a mapping")
    return data


def _set_path(cfg: dict, path: str, value: Any) -> None:
    keys = path.split(".")
    d = cfg
    for k in keys[:-1]:
        d = d.setdefault(k, {})
        if not isinstance(d, dict):
            return
    d[keys[-1]] = value


_no_default = object()


def get(path: str, default: Any = _no_default) -> Any:
    """``get("scheduler.worker-saturation")`` → 1.1"""
    d: Any = _config
    for k in path.split("."):
        if isinstance(d, Mapping) and k in d:
            d = d[k]
        else:
            if default is _no_default:
                raise KeyError(path)
            return default
    return d


def set(arg: Mapping[str, Any] | None = None, **kwargs: Any):
    """Set config values by dot-path.  Usable as a context manager."""
    updates: dict[str, Any] = dict(arg or {})
    for k, v in kwargs.items():
        updates[k.replace("__", ".").replace("_", "-")] = v
    old: dict[str, Any] = {}
    with _lock:
        for path, value in updates.items():
            old[path] = get(path, _absent)
            _set_path(_config, path, value)
    return _ConfigRestore(old)


_absent = object()


def _del_path(cfg: dict, path: str) -> None:
    keys = path.split(".")
    d = cfg
    for k in keys[:-1]:
        d = d.get(k)
        if not isinstance(d, dict):
            return
    d.pop(keys[-1], None)


class _ConfigRestore:
    def __init__(self, old: dict[str, Any]):
        self._old = old

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        with _lock:
            for path, value in self._old.items():
                if value is _absent:
                    _del_path(_config, path)
                else:
                    _set_path(_config, path, value)


@contextmanager
def override(**kwargs: Any):
    with set(**kwargs):
        yield


# -- duration / byte parsing -------------------------------------------------

_TIME_UNITS = {
    "us": 1e-6, "ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0,
    "second": 1.0, "seconds": 1.0, "minute": 60.0, "minutes": 60.0,
    "hour": 3600.0, "hours": 3600.0, "day": 86400.0, "days": 86400.0,
}
_BYTE_UNITS = {
    "b": 1, "kb": 10**3, "mb": 10**6, "gb": 10**9, "tb": 10**12,
    "kib": 2**10, "mib": 2**20, "gib": 2**30, "tib": 2**40,
    "k": 10**3, "m": 10**6, "g": 10**9, "t": 10**12,
}


def parse_timedelta(value: Any, default: str = "seconds") -> float | None:
    """'100ms' → 0.1; '5 minutes' → 300.0; numbers pass through (in seconds)."""
    if value is None:
        return None
    if isinstance(value, (int, float)):
        return float(value)
    s = str(value).strip().lower().replace(" ", "")
    num = ""
    for i, c in enumerate(s):
        if c.isdigit() or c in ".+-e" and (c != "e" or (num and num[-1].isdigit())):
            num += c
        else:
            unit = s[i:]
            break
    else:
        unit = default
    unit = unit or default
    if unit not in _TIME_UNITS:
        raise ValueError(f"unknown time unit in {value!r}")
    return float(num) * _TIME_UNITS[unit]


def parse_bytes(value: Any) -> int:
    """'64MiB' → 67108864; '50MB' → 50000000; ints pass through."""
    if isinstance(value, (int, float)):
        return int(value)
    s = str(value).strip().lower().replace(" ", "")
    num = ""
    for i, c in enumerate(s):
        if c.isdigit() or c == ".":
            num += c
        else:
            unit = s[i:]
            break
    else:
        unit = "b"
    if unit not in _BYTE_UNITS:
        raise ValueError(f"unknown byte unit in {value!r}")
    return int(float(num) * _BYTE_UNITS[unit])


refresh()
