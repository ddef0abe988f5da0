"""Virtual clock: the simulator's single source of time.

Every timestamp inside a simulated cluster — scheduler transition-log
rows, flight-recorder events, journal records, telemetry snapshots,
steal-cycle bounds — reads this clock instead of ``utils.misc.time``
(the injection seams: ``SchedulerState(clock=...)``,
``WorkerState(clock=...)``, ``FlightRecorder.clock``,
``LinkTelemetry.clock``, ``WorkStealing.clock``).  Time only moves when
the event heap pops the next event, so:

- a run's virtual makespan is a pure function of the workload, the link
  profile, and the policies — immune to the host's documented 2x
  wall-clock drift (PERF.md);
- two same-seed runs advance through the *identical* sequence of
  instants, which is what makes whole-run digests bit-comparable.

The clock is callable (``clock()``) so it drops into every seam that
expects the ``utils.misc.time`` signature.
"""

from __future__ import annotations


class VirtualClock:
    """Monotone virtual time in seconds.  Only the event loop advances
    it (``advance_to``); everything else just reads."""

    __slots__ = ("_now",)

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def __call__(self) -> float:
        return self._now

    @property
    def now(self) -> float:
        return self._now

    def advance_to(self, t: float) -> None:
        if t < self._now:
            raise ValueError(
                f"virtual time cannot run backwards: {t} < {self._now}"
            )
        self._now = t

    def __repr__(self) -> str:
        return f"<VirtualClock t={self._now:.6f}>"
