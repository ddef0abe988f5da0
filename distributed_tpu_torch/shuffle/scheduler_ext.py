"""Scheduler-side shuffle control plane (reference
shuffle/_scheduler_plugin.py).

Owns the authoritative run spec per shuffle id:

- assigns output partitions to workers round-robin over the running
  workers (reference _calculate_worker_for, _scheduler_plugin.py:182);
- hands the CURRENT epoch's spec to task bodies via the
  ``shuffle_get_run`` RPC (workers never trust a spec baked into the
  graph — it may predate a restart);
- on participating-worker loss or a duplicate output fetch, bumps the
  ``run_id`` epoch, reassigns output partitions over the surviving
  workers, rewrites the unpack tasks' worker restrictions, and releases
  the shuffle's transfer/barrier/unpack tasks so the whole run is
  recomputed under the new epoch (reference remove_worker /
  _restart_shuffle, _scheduler_plugin.py:336-344).

The port's copy of ``distributed_tpu/shuffle/scheduler_ext.py``, line for
line.  The device-ownership mode reads ``jax_devices``, the key under which
the port's worker registers the mesh indices its process-group join sets
(``worker/join.py``), as the reference's does.
"""

from __future__ import annotations

import logging
from typing import Any

from distributed_tpu_torch import config
from distributed_tpu_torch.exceptions import P2PShuffleError
from distributed_tpu_torch.utils.misc import seq_name

logger = logging.getLogger("distributed_tpu_torch.shuffle")


class ShuffleState:
    __slots__ = ("id", "run_id", "npartitions_out", "n_inputs", "worker_for",
                 "participants", "attempts", "device_owned", "wants_device")

    def __init__(self, id: str, run_id: int, npartitions_out: int,
                 n_inputs: int, worker_for: dict[int, str]):
        self.id = id
        self.run_id = run_id
        self.npartitions_out = npartitions_out
        self.n_inputs = n_inputs
        self.worker_for = worker_for
        # every worker that touched this epoch (transfer-only workers
        # included) — the barrier must flush ALL of them, not just output
        # owners (reference _scheduler_plugin.py:95)
        self.participants: set[str] = set()
        # consecutive epoch restarts without a completed barrier: bounded
        # by shuffle.max-restarts, reset on barrier success
        self.attempts = 0
        # worker_for came from pod device ownership (multihost plane);
        # wants_device records that the graph builder asked for it, so
        # epoch restarts recompute the same way
        self.device_owned = False
        self.wants_device = False

    @property
    def all_workers(self) -> set[str]:
        return self.participants | set(self.worker_for.values())

    def to_msg(self) -> dict:
        return {
            "id": self.id,
            "run_id": self.run_id,
            "npartitions_out": self.npartitions_out,
            "n_inputs": self.n_inputs,
            "device_owned": self.device_owned,
            "worker_for": {str(k): v for k, v in self.worker_for.items()},
        }


class ShuffleSchedulerExtension:
    """Registered as ``extensions['shuffle']`` (reference
    DEFAULT_EXTENSIONS, scheduler.py:178-193)."""

    def __init__(self, scheduler: Any):
        self.scheduler = scheduler
        self.active: dict[str, ShuffleState] = {}
        # restart coalescing: worker departures arrive one remove_worker
        # call at a time even when a whole scale-down leaves together; a
        # debounce window turns N departures into ONE epoch restart
        # (reference _scheduler_plugin.py:336-344 restarts per event)
        self._pending_restarts: dict[str, str] = {}  # id -> first reason
        self.max_restarts = int(config.get("shuffle.max-restarts") or 0)
        self.restart_debounce = config.parse_timedelta(
            config.get("shuffle.restart-debounce")
        )
        scheduler.handlers.update(
            {
                "shuffle_get_or_create": self.handle_get_or_create,
                "shuffle_get_run": self.handle_get_run,
                "shuffle_restart": self.handle_restart,
                "shuffle_barrier": self.handle_barrier,
            }
        )

    # ------------------------------------------------------------ helpers

    def _calculate_worker_for(self, npartitions_out: int,
                              device: bool = False) -> tuple[dict[int, str], bool]:
        """Map output partitions to workers.

        Device-ownership mode: when workers joined a pod-wide jax
        runtime (``--jax-coordinator``) they registered their global
        mesh device indices; if those DISJOINTLY cover partitions
        0..n-1, partition j is pinned to the process owning mesh device
        j — the device data plane then never moves a shard off its
        chips.  Otherwise: round-robin over sorted running workers
        (reference _scheduler_plugin.py:182).  Returns
        ``(worker_for, device_owned)``."""
        state = self.scheduler.state
        if device:
            # ONLY device-plane shuffles ask for ownership mapping: a
            # host-object shuffle must keep spreading over the whole
            # cluster (ownership would concentrate every partition on
            # the pod workers)
            owners: dict[int, str] = {}
            disjoint = True
            for ws in state.running:
                for d in ws.extra.get("jax_devices") or ():
                    if d in owners:
                        disjoint = False
                    owners[int(d)] = ws.address
            if (
                disjoint
                and owners
                and all(j in owners for j in range(npartitions_out))
            ):
                return {j: owners[j] for j in range(npartitions_out)}, True
        addrs = sorted(ws.address for ws in state.running)
        if not addrs:
            addrs = sorted(state.workers)
        if not addrs:
            raise RuntimeError("no workers available for shuffle")
        return {j: addrs[j % len(addrs)] for j in range(npartitions_out)}, False

    def _task_keys(self, st: ShuffleState) -> list[str]:
        """Insertion order matters: the transition engine drains
        recommendations LIFO (``dict.popitem``), so listing transfers
        first and unpacks last makes DEPENDENTS transition first —
        releasing a producer before its processing dependent would trip
        the scheduler's dep-missing invariant mid-drain."""
        keys = [f"{st.id}-transfer-{i}" for i in range(st.n_inputs)]
        keys.append(f"{st.id}-barrier")
        keys.extend(f"{st.id}-unpack-{j}" for j in range(st.npartitions_out))
        return keys

    def _pin_tasks_home(self, st: ShuffleState) -> None:
        """Exempt this shuffle's tasks from work stealing (``ts.homed``,
        same flag the partition planner uses).  A transfer splits ITS
        OWN input partition in place and unpack is restriction-pinned to
        its output owner: stealing either moves megabytes to save
        milliseconds, and on top of the locality damage the stealable
        backlog they create was measured dragging the DEVICE balance
        kernel into every tick of a 128-worker shuffle (~24% of e2e
        wall went to deciding not to steal)."""
        tasks = self.scheduler.state.tasks
        stealing = getattr(
            self.scheduler.state, "extensions", {}
        ).get("stealing")
        for key in self._task_keys(st):
            ts = tasks.get(key)
            if ts is not None:
                # "pin", not "plan": the flag stays truthy for the
                # steal exemption, but the decision ledger must not
                # attribute shuffle pins to the jax partition planner
                # (ts.homed carries provenance; state.py TaskState)
                ts.homed = "pin"
                if stealing is not None:
                    # already-queued tasks entered stealable before the
                    # first worker registered this shuffle: purge them,
                    # or they keep tripping the device-balance gate
                    stealing.remove_key_from_stealable(ts)

    def _closing(self) -> bool:
        return (
            self.scheduler.status.name in ("closing", "closed")
            or getattr(self.scheduler, "draining", False)
        )

    def _request_restart(self, st: ShuffleState, reason: str) -> None:
        """Coalescing entry point for every restart cause (worker loss,
        barrier failure, worker-requested): causes arriving within the
        debounce window restart the epoch ONCE, and repeated restarts
        back off exponentially."""
        if self._closing():
            return
        if st.id in self._pending_restarts:
            return  # already scheduled: this cause rides along
        self._pending_restarts[st.id] = reason
        delay = min(
            self.restart_debounce * (2 ** min(st.attempts, 6)), 2.0
        )
        # per-shuffle timer: a shared drain would let shuffle B's short
        # debounce fire shuffle A's restart early, collapsing A's backoff
        self.scheduler._ongoing_background_tasks.call_later(
            delay, self._drain_restart, st.id
        )

    async def _drain_restart(self, id: str) -> None:
        reason = self._pending_restarts.pop(id, None)
        if reason is None or self._closing():
            return
        st = self.active.get(id)
        if st is None:
            return
        st.attempts += 1
        if self.max_restarts and st.attempts > self.max_restarts:
            self._fail(st, reason)
        else:
            self._restart(st, reason)

    def _fail(self, st: ShuffleState, reason: str) -> None:
        """Restart budget exhausted: err the shuffle's output tasks so
        clients get a P2PShuffleError instead of an endless restart storm."""
        logger.error(
            "shuffle %s failed after %d restarts (%s)",
            st.id, st.attempts - 1, reason,
        )
        self.active.pop(st.id, None)
        state = self.scheduler.state
        exc = P2PShuffleError(
            f"shuffle {st.id} failed after {st.attempts - 1} restarts: "
            f"{reason}"
        )
        recs: dict[str, str] = {}
        for k in self._task_keys(st):
            ts = state.tasks.get(k)
            if ts is None or ts.state in ("erred", "forgotten"):
                continue
            # preset the blame so any-state -> erred composes through
            # released (state._transition routes untable'd pairs there,
            # and _transition_waiting_released checks exception_blame
            # before resurrecting a wanted task)
            ts.exception = exc
            ts.exception_text = str(exc)
            ts.exception_blame = ts
            if state.native is not None:  # blame flag lives in the SoA
                state.native.mark_task(ts)
            recs[k] = "erred"
        if recs:
            stimulus_id = seq_name("shuffle-failed")
            client_msgs, worker_msgs = state.transitions(recs, stimulus_id)
            self.scheduler.send_all(client_msgs, worker_msgs)

    def _restart(self, st: ShuffleState, reason: str) -> None:
        st.run_id += 1
        try:
            st.worker_for, st.device_owned = self._calculate_worker_for(
                st.npartitions_out, device=st.wants_device
            )
        except RuntimeError:
            # no workers left (cluster draining): the shuffle cannot be
            # recomputed now; drop it so task bodies get unknown-shuffle
            # and reschedule when workers return
            logger.warning("shuffle %s unrecoverable (%s): no workers", st.id, reason)
            self.active.pop(st.id, None)
            return
        st.participants = set()  # re-registered as the new epoch's tasks run
        logger.warning(
            "shuffle %s restarting as run %d (%s)", st.id, st.run_id, reason
        )
        state = self.scheduler.state
        # retarget unpack restrictions at the new owners
        for j, addr in st.worker_for.items():
            ts = state.tasks.get(f"{st.id}-unpack-{j}")
            if ts is not None:
                ts.worker_restrictions = {addr}
                if state.native is not None:  # restriction flag -> SoA
                    state.native.mark_task(ts)
        # release the whole pipeline for recomputation under the new epoch
        recs = {
            k: "released"
            for k in self._task_keys(st)
            if k in state.tasks and state.tasks[k].state != "released"
        }
        if recs:
            stimulus_id = seq_name("shuffle-restart")
            client_msgs, worker_msgs = state.transitions(recs, stimulus_id)
            self.scheduler.send_all(client_msgs, worker_msgs)
        # releasing clears ts.homed: re-exempt the new epoch's tasks
        self._pin_tasks_home(st)

    # ----------------------------------------------------------- handlers

    async def handle_get_or_create(
        self, id: str = "", npartitions_out: int = 0, n_inputs: int = 0,
        worker: str = "", device: bool = False, **kwargs: Any,
    ) -> dict:
        st = self.active.get(id)
        if st is None:
            worker_for, device_owned = self._calculate_worker_for(
                npartitions_out, device=device
            )
            st = self.active[id] = ShuffleState(
                id, 1, npartitions_out, n_inputs, worker_for,
            )
            st.device_owned = device_owned
            st.wants_device = bool(device)
            self._pin_tasks_home(st)
        if worker:
            st.participants.add(worker)
        return {"status": "OK", "spec": st.to_msg(),
                "device_owned": st.device_owned}

    async def handle_get_run(self, id: str = "", worker: str = "",
                             **kwargs: Any) -> dict:
        st = self.active.get(id)
        if st is None:
            return {"status": "unknown-shuffle", "id": id}
        if worker:
            st.participants.add(worker)
        return {"status": "OK", "spec": st.to_msg()}

    async def handle_barrier(self, id: str = "", run_id: int = 0,
                             **kwargs: Any) -> dict:
        """Broadcast inputs_done to EVERY participating worker (transfer
        and unpack) and wait for each to flush its outbound shard buffer
        before acknowledging — only then may the barrier task complete and
        unpacks start reading (reference _scheduler_plugin.py:95,
        _core.py:272)."""
        import asyncio

        st = self.active.get(id)
        if st is None:
            return {"status": "unknown-shuffle", "id": id}
        if run_id != st.run_id:
            return {"status": "stale", "id": id, "run_id": st.run_id}
        spec = st.to_msg()

        async def one(addr: str):
            resp = await self.scheduler.rpc(addr).shuffle_inputs_done(
                id=id, run_id=run_id, spec=spec
            )
            if resp.get("status") != "OK":
                raise RuntimeError(
                    f"inputs_done rejected by {addr}: {resp!r}"
                )
            return addr, resp.get("sent") or {}

        results = await asyncio.gather(
            *(one(a) for a in sorted(st.all_workers)), return_exceptions=True
        )
        failures = [r for r in results if isinstance(r, BaseException)]
        if not failures:
            # round 2: every RECEIVER confirms it processed the pushes
            # the senders reported — the scheduler aggregates the counts
            # so confirmation costs ONE rpc per worker instead of a
            # flush round trip per (sender, receiver) pair
            expected: dict[str, dict[str, int]] = {}
            for addr, sent in results:
                for peer, n in sent.items():
                    expected.setdefault(peer, {})[addr] = int(n)

            async def confirm(addr: str):
                resp = await self.scheduler.rpc(addr).shuffle_wait_pushes(
                    id=id, run_id=run_id, expected=expected.get(addr) or {}
                )
                if resp.get("status") != "OK":
                    raise RuntimeError(
                        f"push confirmation failed on {addr}: {resp!r}"
                    )

            res2 = await asyncio.gather(
                *(confirm(a) for a in sorted(expected)),
                return_exceptions=True,
            )
            failures = [r for r in res2 if isinstance(r, BaseException)]
        if failures:
            # a participant died or went stale mid-barrier: restart the
            # epoch rather than serve partial outputs
            if run_id == st.run_id:
                self._request_restart(st, f"barrier failed: {failures[0]!r}")
            # NOT "status": "error" — that is the RPC layer's reserved
            # pickled-exception envelope (raise_remote_error); the task
            # body maps any non-OK status to ShuffleClosedError itself
            return {"status": "barrier-failed", "error": repr(failures[0])}
        st.attempts = 0  # a completed barrier proves the epoch is healthy
        return {"status": "OK", "run_id": run_id}

    async def handle_restart(self, id: str = "", run_id: int = 0,
                             **kwargs: Any) -> dict:
        """A worker hit a fatal run condition (e.g. duplicate output
        fetch): restart iff the reported epoch is still current."""
        st = self.active.get(id)
        if st is None:
            return {"status": "unknown-shuffle", "id": id}
        if run_id == st.run_id:
            self._request_restart(st, f"worker-requested (run {run_id})")
        return {"status": "OK", "run_id": st.run_id}

    # ------------------------------------------------- scheduler callbacks

    def remove_worker(self, scheduler: Any, address: str) -> None:
        """Participating worker died: every shuffle it owned outputs for
        or held transfer state for restarts under a new epoch
        (reference _scheduler_plugin.py:344)."""
        if self._closing():
            # cluster shutdown: workers leave one by one — restarting
            # each active shuffle per departure is noise, not recovery
            self.active.clear()
            self._pending_restarts.clear()
            return
        for st in list(self.active.values()):
            if address in st.all_workers:
                self._request_restart(st, f"lost worker {address}")

    def forget(self, id: str) -> None:
        self.active.pop(id, None)

    def close(self) -> None:
        """Scheduler shutdown: abandon active runs and pending restarts —
        departures during close must not spawn recovery work."""
        self.active.clear()
        self._pending_restarts.clear()
