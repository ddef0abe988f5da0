"""Active Memory Manager: replica creation/destruction policies
(reference active_memory_manager.py).

Every ``interval`` (2 s default) the extension polls its policies; each
policy yields ``Suggestion("replicate" | "drop", ts, candidates)``.  The
extension picks the recipient with the lowest projected memory for
replications and the holder with the highest for drops
(reference active_memory_manager.py:233,290), then enacts the round via
``acquire-replicas`` / ``remove-replicas`` worker messages.  The worker
side already closes the loop: acquire -> gather -> add-keys registers the
replica; remove -> release-worker-data unregisters it.

``ReduceReplicas`` trims replicas beyond current waiter demand — the
north-star bin-packing target.  With the JAX co-processor enabled and
enough replicated tasks, the whole round's drop selection runs as one
device call (``distributed_tpu_torch.ops.amm.plan_drops``: K Jacobi rounds
peeling replicas off the highest-projected-memory holders); suggestions
still flow through ``_find_dropper``'s safety guards.  ``RetireWorker``
evacuates unique data for graceful retirement.

The port's copy of ``distributed_tpu/scheduler/amm.py``, in two parts.

1. ``ActiveMemoryManagerExtension``, ``ReduceReplicas`` and
   ``RetireWorker`` (``:46-418``), line for line but for
   ``ReduceReplicas``' device seam.  Its gate reads the port's
   ``scheduler.jax.*`` configuration (``gate.config_gate``); a round the
   gate sends to the device runs :meth:`AmmPath.run_device` on
   ``state.device``, so K8 runs with no install step.  A failure there is
   counted on the path and raised out of the policy's generator (the
   reference logs it and drops in python); the manager's ``run_once`` then
   logs a failing policy, as it does for any policy.
2. The device path, :class:`AmmPath`: the port's copies of the
   reference's ``ReduceReplicas.run`` and ``_run_device`` (``:303-393``),
   which :func:`install_amm` also binds onto a reference ``ReduceReplicas``
   *instance*.  An installed path keeps the reference's gate (explicit
   parameters here, see ``gate.py``) and its python generator for the
   cycles the gate keeps on the host; the device round builds the replica
   matrix over the mirror's slots and plans all drops in one call of
   ``ops/amm.py::plan_drops`` (kernel K8 on the card).  Each suggestion
   still passes the manager's ``_find_dropper`` guards.
"""

from __future__ import annotations

import functools
import logging
from collections import defaultdict
from typing import TYPE_CHECKING, Any, Generator, Iterable

import numpy as np

from distributed_tpu_torch import config
from distributed_tpu_torch._device import resolve_device
from distributed_tpu_torch.graph.spec import Key
from distributed_tpu_torch.ops import amm as ops_amm
from distributed_tpu_torch.rpc.core import PeriodicCallback
from distributed_tpu_torch.scheduler.gate import (
    DevicePath,
    config_gate,
    device_dispatch_worthwhile,
)
from distributed_tpu_torch.scheduler.stealing import ensure_mirror
from distributed_tpu_torch.utils.collections import OrderedSet
from distributed_tpu_torch.utils.misc import import_term, seq_name

if TYPE_CHECKING:
    from distributed_tpu_torch.scheduler.state import TaskState, WorkerState

logger = logging.getLogger("distributed_tpu_torch.amm")

Suggestion = tuple  # (op, ts, candidates | None)


class ActiveMemoryManagerExtension:
    """Scheduler extension (reference active_memory_manager.py:40)."""

    def __init__(self, scheduler: "Scheduler", policies: Iterable | None = None,
                 *, register: bool = True, start: bool | None = None,
                 interval: float | None = None):
        self.scheduler = scheduler
        self.state = scheduler.state
        # registration-ordered: policy run order decides suggestion
        # precedence within a round, so it must not be hash-ordered
        self.policies: OrderedSet[ActiveMemoryManagerPolicy] = OrderedSet()
        if policies is None:
            policies = []
            for spec in config.get("scheduler.active-memory-manager.policies"):
                kwargs = dict(spec)
                cls = import_term(kwargs.pop("class"))
                policies.append(cls(**kwargs))
        for policy in policies:
            self.add_policy(policy)
        if register:
            scheduler.extensions["amm"] = self
            scheduler.handlers["amm_run_once"] = self.run_once_handler
            scheduler.handlers["amm_start"] = self.start_handler
            scheduler.handlers["amm_stop"] = self.stop_handler
        self.interval = (
            interval
            if interval is not None
            else config.parse_timedelta(
                config.get("scheduler.active-memory-manager.interval")
            )
        )
        self._pc = PeriodicCallback(self._tick, self.interval)
        if start is None:
            start = config.get("scheduler.active-memory-manager.start")
        if register and start:
            scheduler.periodic_callbacks["amm"] = self._pc
        # injectable stimulus-id mint (ROADMAP item 1 simulator):
        # seq_name is a process-global counter, so the sim swaps in a
        # per-run deterministic mint to keep same-seed digests identical
        self.seq = seq_name
        # round-local bookkeeping (reference amm.py:58-66)
        self.pending: dict = {}
        self.workers_memory: dict = {}

    def add_policy(self, policy: "ActiveMemoryManagerPolicy") -> None:
        policy.manager = self
        self.policies.add(policy)

    async def close(self) -> None:
        self._pc.stop()

    async def run_once_handler(self) -> str:
        self.run_once()
        return "OK"

    async def start_handler(self) -> str:
        self._pc.start()
        return "OK"

    async def stop_handler(self) -> str:
        self._pc.stop()
        return "OK"

    async def _tick(self) -> None:
        self.run_once()

    # ------------------------------------------------------------ one round

    def run_once(self) -> None:
        stimulus_id = self.seq("amm")
        # projected memory per worker for this round: actual managed
        # bytes plus/minus the round's own decisions (reference
        # amm.py:~200).  Kept as an OVERLAY over live ``ws.nbytes``
        # (``_projected``) instead of a pre-seeded dict: the old
        # ``{ws: ws.nbytes for ws in workers}`` was an O(W) Python loop
        # per 2 s round, paid even when no policy suggested anything.
        self.workers_memory = {}
        try:
            # pending[ts] -> (set of recipients, set of droppers)
            self.pending = {}
            for policy in list(self.policies):
                try:
                    gen = policy.run()
                    while True:
                        try:
                            cmd = next(gen)
                        except StopIteration:
                            break
                        self._handle_suggestion(cmd)
                except Exception:
                    logger.exception("AMM policy %r failed", policy)
            drop_by_worker: defaultdict = defaultdict(list)
            repl_by_worker: defaultdict = defaultdict(dict)
            state = self.state
            ledger = state.ledger
            for ts, (recipients, droppers) in self.pending.items():
                if recipients:
                    holders = [wss.address for wss in ts.who_has]
                    for ws in recipients:
                        repl_by_worker[ws.address][ts.key] = holders
                        if ledger.enabled:
                            # decision ledger (ledger.py): one amm-repl
                            # row per (key, recipient), joined when the
                            # replica's add-keys lands — regret audits
                            # the predicted transfer price vs realized
                            # acquire latency
                            nb = ts.get_nbytes()
                            measured, used = (
                                state.get_replica_cost_measured(ts, ws)
                            )
                            ledger.file_amm(
                                "amm-repl", ts.key, ws.address,
                                stimulus_id,
                                pred_constant=(
                                    nb / state.bandwidth
                                    + state.transfer_latency
                                ),
                                pred_measured=measured,
                                used_measured=used, nbytes=nb,
                                src=holders[0] if holders else "",
                            )
                for ws in droppers:
                    drop_by_worker[ws.address].append(ts.key)
                    if ledger.enabled:
                        # drops predict no transfer; the row audits the
                        # decision->release-worker-data latency only
                        ledger.file_amm(
                            "amm-drop", ts.key, ws.address, stimulus_id,
                            nbytes=ts.get_nbytes(),
                        )
            worker_msgs: dict = {}
            for addr, who_has in repl_by_worker.items():
                worker_msgs.setdefault(addr, []).append({
                    "op": "acquire-replicas",
                    "who_has": who_has,
                    "nbytes": {
                        k: self.state.tasks[k].nbytes
                        for k in who_has if k in self.state.tasks
                    },
                    "stimulus_id": stimulus_id,
                })
            for addr, keys in drop_by_worker.items():
                worker_msgs.setdefault(addr, []).append({
                    "op": "remove-replicas",
                    "keys": keys,
                    "stimulus_id": stimulus_id,
                })
            # flight-recorder kernel hop: the AMM round's decisions are
            # joined to its stimulus id (the acquire/remove-replicas
            # envelopes and resulting transitions carry the same id)
            self.state.trace.emit(
                "kernel", "amm-cycle", stimulus_id, n=len(self.pending)
            )
            if worker_msgs:
                self.scheduler.send_all({}, worker_msgs)
        finally:
            self.pending = {}
            self.workers_memory = {}

    def _projected(self, ws: "WorkerState") -> float:
        """This round's projected managed memory: live bytes overlaid
        with the round's own pending decisions."""
        mem = self.workers_memory.get(ws)
        return ws.nbytes if mem is None else mem

    def _handle_suggestion(self, cmd: Suggestion) -> None:
        op, ts, candidates = cmd
        # decision order: these are iterated to file ledger rows and
        # build the acquire/remove envelopes
        recipients, droppers = self.pending.setdefault(
            ts, (OrderedSet(), OrderedSet())
        )
        if op == "replicate":
            ws = self._find_recipient(ts, candidates, recipients)
            if ws is not None:
                recipients.add(ws)
                self.workers_memory[ws] = (
                    self._projected(ws) + ts.get_nbytes()
                )
        elif op == "drop":
            ws = self._find_dropper(ts, candidates, recipients, droppers)
            if ws is not None:
                droppers.add(ws)
                self.workers_memory[ws] = max(
                    0, self._projected(ws) - ts.get_nbytes()
                )

    def _find_recipient(self, ts: "TaskState", candidates, pending_repl
                        ) -> "WorkerState | None":
        """Lowest projected memory among eligible non-holders
        (reference amm.py:233)."""
        if ts.state != "memory":
            return None
        if candidates is None:
            candidates = set(self.state.running)
        else:
            candidates = {ws for ws in candidates if ws in self.state.running}
        candidates -= ts.who_has
        candidates -= pending_repl
        if not candidates:
            return None
        # address tiebreak: equal projections must not fall back to
        # hash-seed set order
        return min(candidates, key=lambda ws: (self._projected(ws), ws.address))

    def _find_dropper(self, ts: "TaskState", candidates, pending_repl,
                      pending_drop) -> "WorkerState | None":
        """Highest projected memory among holders, never dropping the last
        replica or one under active use (reference amm.py:290)."""
        if len(ts.who_has) - len(pending_drop) < 2:
            return None
        if candidates is None:
            candidates = set(ts.who_has)
        else:
            candidates = {ws for ws in candidates if ws in ts.who_has}
        candidates -= pending_drop
        candidates -= pending_repl
        # don't drop from a worker about to run a dependent of ts
        candidates -= {
            waiter_ts.processing_on
            for waiter_ts in ts.waiters
            if waiter_ts.processing_on is not None
        }
        if not candidates:
            return None
        # address tiebreak: equal projections must not fall back to
        # hash-seed set order
        return max(candidates, key=lambda ws: (self._projected(ws), ws.address))


class ActiveMemoryManagerPolicy:
    """Base policy (reference active_memory_manager.py:431)."""

    manager: ActiveMemoryManagerExtension

    def run(self) -> Generator[Suggestion, None, None]:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


class ReduceReplicas(ActiveMemoryManagerPolicy):
    """Drop replicas beyond current waiter demand
    (reference active_memory_manager.py:527)."""

    # below this many replicated tasks a device dispatch costs more than
    # the python generator it replaces
    DEVICE_MIN_TASKS = 64

    @staticmethod
    def _desired(ts: "TaskState") -> int:
        return max(
            1,
            len({
                waiter.processing_on or waiter
                for waiter in ts.waiters
            }) if ts.waiters else 1,
        )

    def run(self) -> Generator[Suggestion, None, None]:
        state = self.manager.state
        replicated = list(state.replicated_tasks)
        if device_dispatch_worthwhile(
            len(state.workers), len(replicated), self.DEVICE_MIN_TASKS,
            periodic=True, **config_gate(),
        ):
            path = self.device_path()
            path.cycles_device += 1
            try:
                yield from self._run_device(replicated)
            except Exception as exc:
                path.fail(exc)
                raise
            return
        for ts in replicated:
            ndrop = len(ts.who_has) - self._desired(ts)
            for _ in range(ndrop):
                yield ("drop", ts, None)

    def _run_device(self, replicated: list) -> Generator[Suggestion, None, None]:
        """Whole-round drop selection in one plan on the port's device
        path (K8 on the state's device; see :meth:`AmmPath.run_device`)."""
        yield from self.device_path().run_device(self, replicated)

    def device_path(self) -> "AmmPath":
        """This policy's device path, on the state's device, made at the
        first round the gate sends to the device."""
        path = getattr(self, "_device_path", None)
        if path is None:
            path = self._device_path = AmmPath(self.manager.state.device, **config_gate())
        return path


class RetireWorker(ActiveMemoryManagerPolicy):
    """Evacuate all unique data from one worker before retirement
    (reference active_memory_manager.py:571)."""

    def __init__(self, address: str):
        self.address = address
        self.done = False

    def run(self) -> Generator[Suggestion, None, None]:
        state = self.manager.state
        ws = state.workers.get(self.address)
        if ws is None:
            self.done = True
            self.manager.policies.discard(self)
            return
        unique = [ts for ts in ws.has_what if len(ts.who_has) == 1]
        if not unique:
            self.done = True
            self.manager.policies.discard(self)
            return
        others = [w for w in state.running if w is not ws]
        for ts in unique:
            yield ("replicate", ts, set(others) if others else None)

    def __repr__(self) -> str:
        return f"RetireWorker({self.address!r}, done={self.done})"


class AmmPath(DevicePath):
    """The device path of one or more ``ReduceReplicas`` policies."""

    def __init__(self, device=None, **gate):
        super().__init__(resolve_device(device), **gate)

    def run(self, policy):
        """The policy's round (the reference's ``ReduceReplicas.run``)."""
        state = policy.manager.state
        replicated = list(state.replicated_tasks)
        if self.worthwhile(len(state.workers), len(replicated), policy.DEVICE_MIN_TASKS):
            self.cycles_device += 1
            try:
                yield from self.run_device(policy, replicated)
            except Exception as exc:
                self.fail(exc)
                raise
            return
        self.cycles_host += 1
        for ts in replicated:
            ndrop = len(ts.who_has) - policy._desired(ts)
            for _ in range(ndrop):
                yield ("drop", ts, None)

    def run_device(self, policy, replicated: list):
        """The whole round's drops in one plan (the reference's
        ``_run_device``): the worker axis is the mirror's slot space when
        the state has a mirror, else the live workers in order."""
        state = policy.manager.state
        mirror = ensure_mirror(state, self.device)
        rows = []
        for ts in replicated:
            ndrop = len(ts.who_has) - policy._desired(ts)
            if ndrop > 0:
                rows.append((ts, ndrop))
        if not rows:
            return
        R = len(rows)
        if mirror is not None:
            fv = mirror.fleet_view()
            W = mirror.cap
            ws_of = fv.ws_of
            slot = lambda ws: ws.idx  # noqa: E731
            mem = fv.nbytes.astype(np.float32, copy=True)
            for ws, v in policy.manager.workers_memory.items():
                if ws.idx >= 0:
                    mem[ws.idx] = v
        else:
            workers = list(state.workers.values())
            widx = {ws: i for i, ws in enumerate(workers)}
            W = len(workers)
            ws_of = workers
            slot = lambda ws: widx.get(ws, -1)  # noqa: E731
            mem = np.asarray([policy.manager._projected(ws) for ws in workers], np.float32)
        holders = np.zeros((R, W), bool)
        excluded = np.zeros((R, W), bool)
        nbytes = np.zeros(R, np.float32)
        ndrops = np.zeros(R, np.int32)
        for r, (ts, ndrop) in enumerate(rows):
            for ws in ts.who_has:
                i = slot(ws)
                if i >= 0:
                    holders[r, i] = True
            for waiter in ts.waiters:
                pw = waiter.processing_on
                if pw is not None:
                    i = slot(pw)
                    if i >= 0:
                        excluded[r, i] = True
            nbytes[r] = ts.get_nbytes()
            ndrops[r] = ndrop
        drops = ops_amm.plan_drops(
            ops_amm.DropBatch(holders, excluded, nbytes, ndrops, mem), device=self.device
        )
        self.launches += 1
        for r, w in drops:
            dropper = ws_of[w]
            if dropper is not None:
                yield ("drop", rows[r][0], {dropper})


def install_amm(policy, device=None, *, path: AmmPath | None = None, **gate) -> AmmPath:
    """Bind the port's device path onto the ``ReduceReplicas`` instance
    ``policy`` and return it (``path`` shares one path's counters among
    several policies).  ``gate`` holds the gate's parameters;
    ``device=None`` means CUDA and raises without one."""
    path = path or AmmPath(device, **gate)
    policy.run = functools.partial(path.run, policy)
    policy._run_device = functools.partial(path.run_device, policy)
    return path
