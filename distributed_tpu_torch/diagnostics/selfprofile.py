"""Control-plane self-profiling: the scheduler watches itself.

``diagnostics/profile.py`` samples worker *executor* threads — the
threads running user tasks.  The paper's innovation, though, lives in
the control plane: the event-loop thread running ``transitions_batch``,
``send_all`` flushes and mirror uploads, and the jax-placement planner
thread.  This module turns those blind spots into a continuously
answered question ("where did the scheduler's second go?") with three
cooperating pieces (docs/observability.md "Self-profiling"):

- :class:`WallBudget` — exact monotonic-clock accumulators per
  control-plane *phase* (``engine.drain``, ``egress.flush``,
  ``kernel.dispatch``, ``mirror.upload``, ``telemetry.fold``, and —
  opt-in, ``scheduler.profile.arm-attribution`` — the per-transition
  ``engine.scalar-arm:<start>,<finish>`` arms).  Phases are entered at
  the existing hot-path seams in ``scheduler/state.py``,
  ``scheduler/server.py``, ``scheduler/jax_placement.py`` and
  ``scheduler/mirror.py``; totals export as
  ``dtpu_wall_seconds_total{phase=}`` at ``/metrics`` and the
  per-arm table is the payoff artifact ``sim.profile_run`` emits
  (ROADMAP item 4's prioritization input).
- :class:`ControlPlaneProfiler` — a :class:`~distributed_tpu_torch.
  diagnostics.profile.Profiler` aimed at the loop/planner thread idents,
  with a ``stop=`` frame boundary so the shared asyncio ``run_forever``
  prefix doesn't swamp the tree, idle selector frames counted apart from
  the signal, and the active phase + stimulus id stamped onto every
  sample (the join to the flight recorder's causal timeline).
- :class:`LoopWatchdog` — a loop-side tick measuring event-loop lag
  into ``dtpu_loop_lag_seconds`` plus an off-loop monitor thread that,
  when the loop stops ticking past ``scheduler.profile.stall-threshold``,
  captures the blocked loop thread's stack via ``sys._current_frames``
  into a flight-recorder ``stall`` event (formatted traceback +
  in-progress phase): the postmortem for "the scheduler froze".

Always-on budget: batch-level phase enters only (a handful of monotonic
reads per engine pass), sampling at a low configurable rate
(``scheduler.profile.interval``), arm attribution off by default.  The
``selfprofile`` bench smoke gates sampling-on overhead <5% on the
engine flood (tests/test_bench_smoke.py).

Covered by graft-lint's monotonic-time rule (diagnostics/**): every
clock read here is the monotonic ``utils.misc.time``, and the watchdog
thread waits on an ``Event``, never ``time.sleep``.
"""

from __future__ import annotations

import logging
import sys
import threading
import traceback as _traceback
from collections import deque
from typing import Any, Callable, Iterable

from distributed_tpu_torch import config
from distributed_tpu_torch.diagnostics.profile import Profiler, create, merge, process
from distributed_tpu_torch.tracing import SECONDS_BUCKETS, Histogram, to_jsonl
from distributed_tpu_torch.utils.misc import time

logger = logging.getLogger("distributed_tpu_torch.selfprofile")

#: phase vocabulary (docs/observability.md "Self-profiling") — the
#: batch-level phases entered unconditionally at the hot-path seams.
#: ``engine.scalar-arm:<start>,<finish>`` (scheduler) and
#: ``wengine.scalar-arm:<start>,<finish>`` (worker) join them when
#: ``scheduler.profile.arm-attribution`` is on.
PHASES = (
    "engine.drain",      # a transition-engine round drained to fixed point
    "wengine.stimulus",  # a worker state-machine stimulus batch
    "egress.flush",      # Scheduler.stream_payload_flush coalescing/writes
    "kernel.dispatch",   # a device placement plan (loop or planner thread)
    "mirror.upload",     # fleet-mirror device upload (scatter or full)
    "telemetry.fold",    # heartbeat telemetry folding into the aggregate
)

#: innermost frames in these files mean "the loop is idle in select()" —
#: counted apart so an idle scheduler's tree stays signal-dense
IDLE_FILES = ("selectors.py",)

#: pseudo-frame prefix for the phase layer stamped under a profile root
PHASE_PREFIX = "phase:"


class WallBudget:
    """Exact wall attribution of control-plane threads by phase.

    A per-thread phase *stack* (entering a child phase pauses the
    parent's accumulation, so every total is **self time**) plus shared
    totals.  ``push``/``pop`` are the hot-path API (two monotonic reads
    and a couple of dict operations each); :meth:`phase` is the
    context-manager convenience for batch-level seams.  The top of each
    thread's stack is published in ``_active`` so the sampler and stall
    watchdog (other threads) can stamp the in-progress phase +
    stimulus id onto samples and stall events.
    """

    def __init__(self, clock: Callable[[], float] = time):
        # REAL monotonic clock even under the simulator: the budget
        # measures python cost, not virtual time (sim.profile_run)
        self.clock = clock
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._lock = threading.Lock()
        self._tls = threading.local()
        # thread ident -> (phase, stimulus) of that thread's stack top
        self._active: dict[int, tuple[str, str]] = {}

    # ------------------------------------------------------------ hot path

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def push(self, phase: str, stim: str = "") -> None:
        now = self.clock()
        st = self._stack()
        if st:
            top = st[-1]
            self._fold(top[0], now - top[2], entered=False)
            top[2] = now
        st.append([phase, stim, now])
        self._active[threading.get_ident()] = (phase, stim)

    def pop(self) -> None:
        now = self.clock()
        st = self._stack()
        if not st:  # unbalanced pop: never corrupt the accumulators
            return
        phase, _stim, seg = st.pop()
        self._fold(phase, now - seg, entered=True)
        ident = threading.get_ident()
        if st:
            top = st[-1]
            top[2] = now
            self._active[ident] = (top[0], top[1])
        else:
            self._active.pop(ident, None)

    def _fold(self, phase: str, dt: float, entered: bool) -> None:
        # the lock covers cross-thread accumulation (loop + planner
        # thread share one budget); push/pop frequency is batch-level
        # unless arm attribution is on, where the cost is opted into
        with self._lock:
            self.totals[phase] = self.totals.get(phase, 0.0) + dt
            if entered:
                self.counts[phase] = self.counts.get(phase, 0) + 1

    # ----------------------------------------------------------- slow path

    def phase(self, name: str, stim: str = ""):
        """``with budget.phase("egress.flush", stim): ...``"""
        return _PhaseCtx(self, name, stim)

    def current(self, ident: int) -> tuple[str, str]:
        """(phase, stimulus) at the top of thread ``ident``'s stack
        ("", "") when it is outside every phase.  Safe from any thread."""
        return self._active.get(ident, ("", ""))

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            return dict(self.totals)

    def snapshot_counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self.counts)

    def clear(self) -> None:
        with self._lock:
            self.totals.clear()
            self.counts.clear()

    def __repr__(self) -> str:
        return f"<WallBudget phases={len(self.totals)}>"


class _PhaseCtx:
    __slots__ = ("_budget", "_name", "_stim")

    def __init__(self, budget: WallBudget, name: str, stim: str):
        self._budget = budget
        self._name = name
        self._stim = stim

    def __enter__(self):
        self._budget.push(self._name, self._stim)
        return self

    def __exit__(self, *exc):
        self._budget.pop()


class ControlPlaneProfiler(Profiler):
    """Statistical profiler for control-plane threads (loop + planner).

    Differences from the executor profiler it extends:

    - defaults come from the ``scheduler.profile.*`` subtree (shared by
      both roles, like ``scheduler.trace.*``), not ``worker.profile``;
    - ``stop`` frame boundary cuts the shared asyncio machinery prefix;
    - samples whose innermost frame sits in ``IDLE_FILES`` count into
      ``idle_samples`` instead of the tree (an idle selector wait is not
      control-plane work);
    - every tree insertion lands under a ``phase:<name>`` pseudo-frame
      read from the :class:`WallBudget` of the sampled thread, and the
      (ts, phase, stimulus) triple of recent samples is kept in
      ``samples`` — the join between profiles and the flight recorder.
    """

    def __init__(self, idents: Callable[[], Iterable[int]],
                 wall: WallBudget | None = None,
                 interval: float | None = None, cycle: float | None = None,
                 maxlen: int | None = None, stop: str | None = None):
        cfg = config.get("scheduler.profile")
        super().__init__(
            thread_filter="dtpu-control-plane",  # unused: idents given
            interval=(
                interval if interval is not None
                else config.parse_timedelta(cfg["interval"])
            ),
            cycle=(
                cycle if cycle is not None
                else config.parse_timedelta(cfg["cycle"])
            ),
            maxlen=maxlen if maxlen is not None else int(cfg["history"]),
            idents=idents,
            stop=stop if stop is not None else (cfg["stop"] or None),
        )
        self.wall = wall
        self.total_samples = 0
        self.idle_samples = 0
        #: recent (ts, phase, stim) sample stamps, newest last
        self.samples: deque[tuple[float, str, str]] = deque(maxlen=512)

    def _add_sample(self, frame, now: float, ident: int | None = None) -> None:
        self.total_samples += 1
        if frame.f_code.co_filename.endswith(IDLE_FILES):
            self.idle_samples += 1
            return
        phase, stim = ("", "")
        if self.wall is not None and ident is not None:
            phase, stim = self.wall.current(ident)
        with self._lock:
            root = self.current
            root["count"] += 1
            process(frame, _phase_node(root, phase), stop=self.stop_file)
            self.samples.append((now, phase, stim))
            if now - self._last_cycle > self.cycle:
                self.history.append((now, self.current))
                self.current = create()
                self._last_cycle = now


def _phase_node(root: dict, phase: str) -> dict:
    ident = PHASE_PREFIX + (phase or "unattributed")
    node = root["children"].get(ident)
    if node is None:
        node = root["children"][ident] = {
            "count": 0,
            "children": {},
            "identifier": ident,
            "description": ident,
        }
    return node


class LoopWatchdog:
    """Tick/stall watchdog for one event loop.

    Loop side: :meth:`tick` runs as a periodic callback and observes the
    loop's scheduling lag (actual gap minus the nominal interval) into
    ``hist_lag`` — a loaded loop shows up as a fattening
    ``dtpu_loop_lag_seconds`` histogram long before anything freezes.

    Thread side: a daemon monitor (``Event.wait`` paced, never a
    blocking sleep) notices when the last tick is older than
    ``stall-threshold`` while the loop is supposed to be alive, and —
    exactly once per stall episode — captures the loop thread's stack
    via ``sys._current_frames()`` into a ``stall`` record and
    flight-recorder event carrying the formatted traceback and the
    in-progress :class:`WallBudget` phase.  The episode re-arms only
    after a fresh tick proves the loop recovered.

    The flight-recorder ring is SINGLE-WRITER by design (``emit`` is an
    unsynchronized in-place slot write on the loop thread), so the
    capture only buffers the event; the first :meth:`tick` after
    recovery writes it into the ring from the loop thread.  The
    ``stalls`` deque and the log warning carry the postmortem
    immediately either way — including when the loop never recovers.
    """

    def __init__(self, trace: Any = None, wall: WallBudget | None = None,
                 interval: float | None = None,
                 stall_threshold: float | None = None,
                 max_stalls: int = 32):
        cfg = config.get("scheduler.profile")
        self.interval = (
            interval if interval is not None
            else config.parse_timedelta(cfg["watchdog-interval"])
        )
        self.stall_threshold = (
            stall_threshold if stall_threshold is not None
            else config.parse_timedelta(cfg["stall-threshold"])
        )
        self.trace = trace
        self.wall = wall
        self.hist_lag = Histogram(SECONDS_BUCKETS)
        self.stalls: deque[dict] = deque(maxlen=max_stalls)
        self.stalls_total = 0
        self.ticks_total = 0
        # stall events captured off-loop, ring-written by tick() on the
        # loop thread (deque append/popleft are GIL-atomic)
        self._pending_events: deque[tuple] = deque()
        self._last_tick = 0.0
        self._loop_ident: int | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ loop side

    def tick(self) -> None:
        now = time()
        if self._last_tick:
            self.hist_lag.observe(max(0.0, now - self._last_tick - self.interval))
        self._last_tick = now
        self.ticks_total += 1
        while self._pending_events:
            # ring writes happen HERE, on the loop thread: the watchdog
            # thread must never race the loop's own emits
            phase, stim, tb, lag_ms = self._pending_events.popleft()
            if self.trace is not None:
                self.trace.emit(
                    "stall", phase or "loop-blocked", stim, key=tb, n=lag_ms
                )

    # ---------------------------------------------------------- thread side

    def start(self, loop_ident: int) -> None:
        self._loop_ident = loop_ident
        self._last_tick = time()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="dtpu-stall-watchdog", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread = None

    def _run(self) -> None:
        # check twice per threshold: a stall is noticed within ~1.5x the
        # threshold without the monitor itself becoming a busy loop
        period = max(min(self.interval, self.stall_threshold / 2), 0.005)
        reported = False
        while not self._stop.wait(period):
            lag = time() - self._last_tick
            if lag <= self.stall_threshold:
                reported = False  # fresh tick seen: episode over, re-arm
                continue
            if reported:
                continue  # one stall event per episode
            reported = True
            try:
                self._capture(lag)
            except Exception:  # pragma: no cover - diagnostics must not kill
                logger.exception("stall capture failed")

    def _capture(self, lag: float) -> None:
        frame = sys._current_frames().get(self._loop_ident)
        tb = "".join(_traceback.format_stack(frame)) if frame is not None else ""
        phase, stim = ("", "")
        if self.wall is not None and self._loop_ident is not None:
            phase, stim = self.wall.current(self._loop_ident)
        rec = {
            "ts": time(),
            "lag_s": round(lag, 4),
            "phase": phase,
            "stim": stim,
            "traceback": tb,
        }
        self.stalls.append(rec)
        self.stalls_total += 1
        # the ring slot's key field carries the formatted traceback (a
        # stall is rare, the postmortem IS the payload); buffered here,
        # ring-written by the next on-loop tick — see the class docstring
        self._pending_events.append(
            (phase, stim, tb, int(lag * 1000))
        )
        logger.warning(
            "event loop stalled %.2fs (phase=%s stim=%s); stack:\n%s",
            lag, phase or "?", stim or "?", tb,
        )


# ------------------------------------------------------------- exposure


def profile_records(role: str, profiler: ControlPlaneProfiler | None,
                    wall: WallBudget | None,
                    watchdog: LoopWatchdog | None,
                    extra_trees: dict[str, dict] | None = None) -> list[dict]:
    """The ``/profile`` route body, shared by both roles: a ``head``
    record (counters, wall totals, recent stalls), one ``profile``
    record per tree (``which`` = ``loop`` / extra keys such as ``exec``),
    and a ``samples`` record with the recent (ts, phase, stim) stamps.
    Serialized with :func:`distributed_tpu_torch.tracing.to_jsonl`."""
    head: dict[str, Any] = {"v": 1, "kind": "head", "role": role}
    if wall is not None:
        head["wall_seconds"] = {
            k: round(v, 6) for k, v in wall.snapshot().items()
        }
        head["wall_entries"] = wall.snapshot_counts()
    if profiler is not None:
        head["samples_total"] = profiler.total_samples
        head["idle_samples"] = profiler.idle_samples
    if watchdog is not None:
        head["ticks_total"] = watchdog.ticks_total
        head["stalls_total"] = watchdog.stalls_total
        head["stalls"] = list(watchdog.stalls)
    records = [head]
    if profiler is not None:
        records.append({
            "v": 1, "kind": "profile", "which": "loop",
            "tree": profiler.get_profile(),
        })
        records.append({
            "v": 1, "kind": "samples",
            "recent": [
                {"ts": ts, "phase": ph, "stim": st}
                for ts, ph, st in list(profiler.samples)
            ],
        })
    for which, tree in (extra_trees or {}).items():
        records.append(
            {"v": 1, "kind": "profile", "which": which, "tree": tree}
        )
    return records


def profile_jsonl(role: str, profiler: ControlPlaneProfiler | None,
                  wall: WallBudget | None, watchdog: LoopWatchdog | None,
                  extra_trees: dict[str, dict] | None = None) -> str:
    return to_jsonl(profile_records(role, profiler, wall, watchdog,
                                    extra_trees))


def profile_to_speedscope(tree: dict, name: str = "dtpu-profile") -> dict:
    """Convert a profile call tree (``diagnostics.profile`` format, as
    served by ``/profile`` ``profile`` records) into a speedscope
    sampled profile (https://www.speedscope.app file format): each
    node's *self* count becomes one weighted sample of its root-first
    stack, so the flamegraph shows exactly the sampled distribution."""
    frames: list[dict] = []
    findex: dict[str, int] = {}
    samples: list[list[int]] = []
    weights: list[int] = []

    def frame_id(node: dict) -> int:
        ident = node["identifier"]
        i = findex.get(ident)
        if i is None:
            i = findex[ident] = len(frames)
            parts = ident.split(";")
            frames.append({
                "name": node.get("description") or parts[0] or ident,
                "file": parts[1] if len(parts) > 1 else "",
                "line": int(parts[2]) if len(parts) > 2
                and parts[2].isdigit() else 0,
            })
        return i

    def walk(node: dict, stack: list[int]) -> None:
        children = node.get("children", {})
        self_count = node.get("count", 0) - sum(
            c.get("count", 0) for c in children.values()
        )
        if self_count > 0 and stack:
            samples.append(stack)
            weights.append(self_count)
        for child in children.values():
            walk(child, stack + [frame_id(child)])

    walk(tree, [])
    total = sum(weights)
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "exporter": "distributed_tpu_torch",
        "name": name,
        "shared": {"frames": frames},
        "profiles": [{
            "type": "sampled",
            "name": name,
            "unit": "none",
            "startValue": 0,
            "endValue": total,
            "samples": samples,
            "weights": weights,
        }],
    }


__all__ = [
    "ControlPlaneProfiler",
    "IDLE_FILES",
    "LoopWatchdog",
    "PHASES",
    "PHASE_PREFIX",
    "WallBudget",
    "merge",
    "profile_jsonl",
    "profile_records",
    "profile_to_speedscope",
]
