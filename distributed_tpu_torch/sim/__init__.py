"""Deterministic sans-io cluster simulator (ROADMAP item 1).

Thousands of real ``WorkerState`` machines + one real scheduler engine
driven off a virtual clock and an event heap — no sockets, no event
loop, no wall clock.  See docs/simulator.md.

Covered by graft-lint's sans-io, monotonic-time, and blocking-in-async
rules: this package must never import IO machinery or read the wall
clock — determinism is the product.
"""

from distributed_tpu_torch.sim.ab import run_ab, run_policy
from distributed_tpu_torch.sim.chaos import SCENARIOS
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
    "SCENARIOS",
    "SimWorker",
    "SyntheticDag",
    "TransitionDigest",
    "VirtualClock",
    "run_ab",
    "run_policy",
]
