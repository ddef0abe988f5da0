"""Statistical profiler (reference profile.py).

A daemon thread samples the stack of every worker-executor thread every
``interval`` (10 ms default, reference distributed.yaml:104-108) and
aggregates frames into a call-tree dict; trees merge across cycles and
across workers (``merge``, reference profile.py:219).  Exposed via
``Worker.get_profile`` / ``Scheduler.get_profile`` RPCs.

The port's copy of ``distributed_tpu/diagnostics/profile.py``, line for
line but for one repair: the shared sampling thread is stopped and joined
at interpreter exit (:meth:`_SharedWatcher.shutdown`, an ``atexit``
hook).  It lingers 0.5 s after its last profiler leaves, so a program that
closes its workers and exits at once left it alive into finalization, and
a daemon thread that wakes into a finalizing interpreter with torch loaded
aborted the process ("terminate called without an active exception",
exit code 134) after its work was done.
"""

from __future__ import annotations

import atexit
import logging
import sys
import threading
from collections import deque
from typing import Any

from distributed_tpu_torch import config
from distributed_tpu_torch.utils.misc import time

logger = logging.getLogger("distributed_tpu_torch.profile")


def create() -> dict:
    return {"count": 0, "children": {}, "identifier": "root", "description": ""}


def _frame_identifier(frame) -> str:
    co = frame.f_code
    return f"{co.co_name};{co.co_filename};{frame.f_lineno}"


def process(frame, state: dict, *, stop: str | None = None) -> None:
    """Add one stack sample to the call tree (reference profile.py:128)."""
    frames = []
    while frame is not None:
        if stop is not None and frame.f_code.co_filename.endswith(stop):
            break
        frames.append(frame)
        frame = frame.f_back
    frames.reverse()
    state["count"] += 1
    node = state
    for fr in frames:
        ident = _frame_identifier(fr)
        child = node["children"].get(ident)
        if child is None:
            child = node["children"][ident] = {
                "count": 0,
                "children": {},
                "identifier": ident,
                "description": fr.f_code.co_name,
            }
        child["count"] += 1
        node = child


def merge(*trees: dict) -> dict:
    """Merge call trees (reference profile.py:219)."""
    out = create()
    for tree in trees:
        if not tree:
            continue
        out["count"] += tree.get("count", 0)
        _merge_children(out["children"], tree.get("children", {}))
    return out


def _merge_children(dst: dict, src: dict) -> None:
    for ident, node in src.items():
        d = dst.get(ident)
        if d is None:
            dst[ident] = {
                "count": node["count"],
                "children": {},
                "identifier": node["identifier"],
                "description": node.get("description", ""),
            }
            _merge_children(dst[ident]["children"], node["children"])
        else:
            d["count"] += node["count"]
            _merge_children(d["children"], node["children"])


class _SharedWatcher:
    """One process-wide sampling thread serving every Profiler.

    In-process clusters run many workers in one interpreter; a sampler
    thread per worker multiplies GIL wakeups and ``sys._current_frames``
    calls by the worker count.  The shared watcher takes ONE frames
    snapshot per tick and feeds each registered profiler its own
    threads' samples."""

    def __init__(self) -> None:
        self._profilers: set = set()
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._wake = threading.Event()
        self._closing = False
        atexit.register(self.shutdown)

    def shutdown(self) -> None:
        """Stop the sampling thread and wait for it to return."""
        with self._lock:
            self._closing = True
            thread = self._thread
        self._wake.set()
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=5.0)  # it wakes at once: a tick's work at most

    def register(self, prof: "Profiler") -> None:
        with self._lock:
            self._profilers.add(prof)
            self._wake.set()
            if self._closing:
                return
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name="dtpu-profiler", daemon=True
                )
                self._thread.start()

    def unregister(self, prof: "Profiler") -> None:
        with self._lock:
            self._profilers.discard(prof)

    def _run(self) -> None:
        while True:
            with self._lock:
                if self._closing:
                    self._thread = None
                    return
                profs = list(self._profilers)
            if not profs:
                # linger briefly for a new registration, then exit
                if self._wake.wait(0.5):
                    self._wake.clear()
                    continue
                with self._lock:
                    if not self._profilers:
                        self._thread = None
                        return
                continue
            interval = min(p.interval for p in profs)
            if self._wake.wait(interval):  # also wakes on new registration
                self._wake.clear()
            now = time()
            wanted: dict[int, list] = {}
            for p in profs:
                try:
                    idents = p._due_idents(now)
                except Exception:
                    # a broken idents/active callback must not kill the
                    # process-wide sampler: drop that profiler only
                    logger.exception("profiler callback failed; dropping")
                    self.unregister(p)
                    continue
                for ident in idents:
                    wanted.setdefault(ident, []).append(p)
            if not wanted:
                continue
            frames = sys._current_frames()
            for ident, targets in wanted.items():
                frame = frames.get(ident)
                if frame is None:
                    continue
                for p in targets:
                    p._add_sample(frame, now, ident)


_shared_watcher = _SharedWatcher()


class Profiler:
    """Statistical profiler handle; sampling runs on the process-shared
    watcher thread (reference profile.py watch :371)."""

    def __init__(self, thread_filter: str = "dtpu-worker-exec",
                 interval: float | None = None, cycle: float | None = None,
                 maxlen: int = 60, idents=None, active=None,
                 stop: str | None = None):
        prof_cfg = config.get("worker.profile")
        self.interval = interval if interval is not None else config.parse_timedelta(
            prof_cfg["interval"]
        )
        self.cycle = cycle if cycle is not None else config.parse_timedelta(
            prof_cfg["cycle"]
        )
        self.thread_filter = thread_filter
        # idents: callable returning the thread idents to sample.  When
        # given, the sampler never calls threading.enumerate() — with N
        # in-process workers each running a profiler, enumerate+name over
        # the whole process's threads was O(N * threads) per tick and
        # measurably starved the (single-core) event loop.
        self.idents = idents
        # active: callable gating sampling; an idle worker skips the
        # sys._current_frames() call entirely
        self.active = active
        # stop: frame boundary — stacks are cut at the first frame whose
        # filename ends with this, so a shared outer prefix (the asyncio
        # run_forever machinery under every control-plane sample) never
        # swamps the tree (reference profile.py:123 ``stop``).  Stored
        # as ``stop_file`` — ``stop()`` is the lifecycle method.
        self.stop_file = stop
        self.current = create()
        self.history: deque = deque(maxlen=maxlen)  # (timestamp, tree)
        self._lock = threading.Lock()

    def start(self) -> None:
        self._last_sample = 0.0
        self._last_cycle = time()
        _shared_watcher.register(self)

    def stop(self) -> None:
        _shared_watcher.unregister(self)
        # flush the in-flight cycle: a short-lived profiler (tests, a
        # worker bounce) would otherwise silently drop everything
        # sampled since the last cycle rollover
        with self._lock:
            if self.current["count"]:
                self.history.append((time(), self.current))
                self.current = create()
                self._last_cycle = time()

    # ------------------------------------------- shared-watcher callbacks

    def _due_idents(self, now: float) -> list:
        """Thread idents to sample this tick ([] when idle or not due)."""
        if now - getattr(self, "_last_sample", 0.0) < self.interval * 0.5:
            return []
        if self.active is not None and not self.active():
            return []  # nothing executing: don't pay for a sample
        self._last_sample = now
        if self.idents is not None:
            return list(self.idents())
        return [
            t.ident
            for t in threading.enumerate()
            if self.thread_filter in (t.name or "")
        ]

    def _add_sample(self, frame, now: float, ident: int | None = None) -> None:
        with self._lock:
            process(frame, self.current, stop=self.stop_file)
            if now - self._last_cycle > self.cycle:
                self.history.append((now, self.current))
                self.current = create()
                self._last_cycle = now

    def get_profile(self, start: float | None = None) -> dict:
        with self._lock:
            trees = [t for ts, t in self.history if start is None or ts >= start]
            trees.append(self.current)
            return merge(*trees)
