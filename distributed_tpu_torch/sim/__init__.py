"""Deterministic sans-io cluster simulator (ROADMAP item 1).

Thousands of real ``WorkerState`` machines + one real scheduler engine
driven off a virtual clock and an event heap — no sockets, no event
loop, no wall clock.  See docs/simulator.md.

The port's copy of ``distributed_tpu/sim``: the clock, the event heap,
the links, the traces, the core (``ClusterSim``) and the validators.  The
A/B driver (``sim/ab.py``), the chaos scenarios (``sim/chaos.py``) and
the profile run are not in the port yet (ROADMAP queue 1).
"""

from distributed_tpu_torch.sim.clock import VirtualClock
from distributed_tpu_torch.sim.core import ClusterSim, SimWorker, TransitionDigest
from distributed_tpu_torch.sim.events import EventHeap
from distributed_tpu_torch.sim.links import LinkProfile
from distributed_tpu_torch.sim.traces import JournalTrace, SyntheticDag

__all__ = [
    "ClusterSim",
    "EventHeap",
    "JournalTrace",
    "LinkProfile",
    "SimWorker",
    "SyntheticDag",
    "TransitionDigest",
    "VirtualClock",
]
