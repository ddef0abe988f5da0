"""Trace sources: the workloads a simulated cluster runs.

Two kinds, per the ROADMAP item 1 contract:

- :class:`SyntheticDag` — a dag_1m-style layered graph generated from a
  seed: scattered root partitions, ``n_layers`` waves of ``layer_width``
  tasks with seeded fan-in onto the previous wave, per-task seeded
  durations/output-bytes.  Submission is **chunked** (a window of
  layers at a time, exactly like a client streaming subgraphs) and
  consumed sinks are released as the window advances, so a 1M-task run
  holds only a bounded frontier of TaskStates resident — that is what
  makes 1M tasks / 10k workers fit in one process.

- :class:`JournalTrace` — a recorded flight-recorder stimulus journal
  (``scheduler.trace.journal``; docs/observability.md).  This replays
  ENGINE stimuli against the scheduler state only (the journal records
  the control plane's inputs, not the data plane), with digest + seq
  verification — the "recorded trace" half of the simulator contract.
"""

from __future__ import annotations

import random
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from distributed_tpu_torch.sim.core import ClusterSim


class SyntheticDag:
    """Seeded layered DAG, submitted in sliding chunks.

    Keys: roots ``root-<i>``; tasks ``c<chunk>L<layer>-<i>`` — the key
    prefix (``key_split``) groups one (chunk, layer) wave into one
    TaskGroup, so keep ``layer_width < 2 * total_nthreads`` if you want
    the non-rootish locality path (the simulator's default regime:
    every task has fan-in, placement follows data).
    """

    def __init__(
        self,
        *,
        n_layers: int,
        layer_width: int,
        fanin: int = 2,
        n_roots: int | None = None,
        layers_per_chunk: int = 2,
        seed: int = 0,
        duration_range: tuple[float, float] = (0.002, 0.02),
        nbytes_range: tuple[int, int] = (1024, 262144),
        root_nbytes: int = 65536,
        linked_chunks: bool = True,
    ):
        self.n_layers = int(n_layers)
        self.layer_width = int(layer_width)
        self.fanin = max(int(fanin), 1)
        self.n_roots = int(n_roots) if n_roots is not None else self.layer_width
        self.layers_per_chunk = max(int(layers_per_chunk), 1)
        self.seed = int(seed)
        self.duration_range = duration_range
        self.nbytes_range = nbytes_range
        self.root_nbytes = int(root_nbytes)
        # linked_chunks=True: one long pipeline — chunk k+1's first
        # layer consumes chunk k's sinks.  Reference-faithful scheduler
        # memory: a released task with live dependents is never
        # forgotten, so the WHOLE chain's TaskStates stay resident
        # until the terminal sinks are released (exactly like a live
        # client holding the final futures of a mega-graph).
        # linked_chunks=False: a stream of independent chunk-graphs off
        # the shared scattered inputs — each completed chunk's sinks
        # have no dependents, so releasing them FORGETS the whole chunk
        # and resident state stays bounded at a few chunks.  The
        # sim_10k headline uses this (1M resident TaskStates plus their
        # worker twins are multiple GB and quadratic-ish GC pressure).
        self.linked_chunks = bool(linked_chunks)
        self.n_chunks = -(-self.n_layers // self.layers_per_chunk)
        self.n_tasks = self.n_layers * self.layer_width
        # filled as the run progresses
        self._rng: random.Random | None = None
        self._rank = 0
        self._sink_keys: list[list[str]] = []   # per chunk
        self._chunk_keys: list[list[str]] = []  # per chunk, all keys
        self._pending_sinks: dict[int, set[str]] = {}
        self._next_chunk = 0
        self._prev_layer: list[str] = []
        self._root_keys: list[str] = []
        self._roots: list[str] = []

    # ------------------------------------------------------------- driving

    def start(self, sim: "ClusterSim") -> None:
        self._rng = random.Random(self.seed)
        sim.source_started()
        addrs = list(sim.workers)
        roots = {
            f"root-{i}": (
                addrs[i % len(addrs)], self.root_nbytes
            )
            for i in range(self.n_roots)
        }
        sim.scatter(roots)
        self._root_keys = list(roots)
        self._roots = list(roots)
        self._prev_layer = list(roots)
        sim.on_key_memory.append(self._on_key_memory)
        self._submit_chunk(sim)

    def _submit_chunk(self, sim: "ClusterSim") -> None:
        rng = self._rng
        assert rng is not None
        c = self._next_chunk
        self._next_chunk += 1
        lo = c * self.layers_per_chunk
        hi = min(lo + self.layers_per_chunk, self.n_layers)
        tasks: list[str] = []
        deps: dict[str, list[str]] = {}
        priorities: dict[str, tuple] = {}
        dmin, dmax = self.duration_range
        bmin, bmax = self.nbytes_range
        prev = self._prev_layer if self.linked_chunks else self._roots
        layer: list[str] = prev
        for j in range(lo, hi):
            layer = [f"c{c}L{j}-{i}" for i in range(self.layer_width)]
            for i, key in enumerate(layer):
                # draw-order dedupe, NOT a set comprehension: the deps
                # iteration order at graph ingest becomes the relation
                # sets' insertion order (= recommendation/digest order),
                # so it must be rng-derived, never hash-seed-derived
                fan = list(dict.fromkeys(
                    prev[rng.randrange(len(prev))] for _ in range(self.fanin)
                ))
                deps[key] = fan
                priorities[key] = (self._rank,)
                self._rank += 1
                sim.set_task_profile(
                    key,
                    rng.uniform(dmin, dmax),
                    rng.randrange(bmin, bmax + 1),
                )
            tasks.extend(layer)
            prev = layer
        self._prev_layer = layer
        self._chunk_keys.append(tasks)
        self._sink_keys.append(list(layer))
        self._pending_sinks[c] = set(layer)
        sim.submit(tasks, deps, keys=layer, priorities=priorities)

    def _on_key_memory(self, sim: "ClusterSim", key: str) -> None:
        # a key belongs to exactly one chunk's sink set; recomputed keys
        # (chaos recovery) re-fire harmlessly against an absent entry
        for chunk, pending in list(self._pending_sinks.items()):
            pending.discard(key)
            if not pending:
                del self._pending_sinks[chunk]
                self._chunk_complete(sim, chunk)

    def _chunk_complete(self, sim: "ClusterSim", chunk: int) -> None:
        if self._next_chunk < self.n_chunks:
            self._submit_chunk(sim)
        elif chunk == self.n_chunks - 1:
            sim.source_finished()
        if chunk == self.n_chunks - 1 and self._root_keys:
            # hold the scattered inputs until the WHOLE workload is
            # done: releasing them mid-run would let a chaos-driven
            # recompute of an early consumer run without its input
            # (pure data cannot be recomputed)
            sim.release_keys(self._root_keys, client="sim-scatter")
            self._root_keys = []
        if chunk > 0:
            # the window moved: the previous chunk's sinks were only
            # wanted as inputs; release them and drop their profiles —
            # this is what bounds resident TaskStates at 1M tasks
            prev = chunk - 1
            if prev < len(self._sink_keys):
                sim.release_keys(self._sink_keys[prev])
            if prev < len(self._chunk_keys):
                for k in self._chunk_keys[prev]:
                    sim.forget_task_profile(k)
                self._chunk_keys[prev] = []


class JournalTrace:
    """Replay a recorded stimulus journal against the simulator's
    scheduler engine (verify + batched re-feed; see
    ``diagnostics.flight_recorder.replay_stimulus_trace``).

    The journal records engine *stimuli*: the scheduler state must be
    prepared the way the recording one was (same workers/tasks) —
    that is the caller's contract, same as live replay.
    """

    def __init__(self, records: list[dict], verify: bool = True):
        self.records = list(records)
        self.verify = verify

    @classmethod
    def from_file(cls, path: str, verify: bool = True) -> "JournalTrace":
        from distributed_tpu_torch.tracing import load_journal

        return cls(load_journal(path), verify=verify)

    def replay(self, sim: "ClusterSim") -> tuple[dict, dict]:
        raise NotImplementedError(
            "replaying a stimulus journal is not in the port yet (ROADMAP "
            "queue 1: the flight-recorder journal and its replay)"
        )
