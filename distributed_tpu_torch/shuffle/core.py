"""P2P shuffle engine (reference shuffle/_core.py, _worker_plugin.py).

All-to-all repartitioning that bypasses the task-graph data model:
N input partitions -> shards pushed directly worker->worker -> M output
partitions, at O(N+M) scheduler tasks instead of O(N*M)
(reference shuffle/_core.py:62-380).

Graph shape (built by ``distributed_tpu_torch.shuffle.api``):

    transfer(i):  split input partition i by output -> push shards to the
                  owner of each output partition (batched direct RPC via
                  CommShardsBuffer)
    barrier:      after all transfers -> broadcast inputs_done to every
                  participant
    unpack(j):    restricted to worker_for[j] -> await inputs_done,
                  assemble output partition j from the spill store

Storage: received shards drain through a ``DiskShardsBuffer`` (spill
files per output partition) or ``MemoryShardsBuffer``, both throttled by
a ``ResourceLimiter`` — a shuffle can move far more data than fits in
memory (reference shuffle/_disk.py, _limiter.py:89).

Control plane: run specs are owned by the SCHEDULER extension
(``shuffle.scheduler_ext``), which assigns output partitions to workers
and bumps the ``run_id`` epoch on participating-worker loss or duplicate
output fetches, releasing the shuffle's tasks for recomputation
(reference shuffle/_scheduler_plugin.py:336-344).  Workers fence stale
epochs by run_id (reference shuffle/_worker_plugin.py:36).

The port's copy of ``distributed_tpu/shuffle/core.py``, line for line: the
pushes go through the port's comm, an unpack leaves its slot through the
port's ``secede``, and ``schedule_cleanup`` forgets the port's device
store's idle epochs.
"""

from __future__ import annotations

import asyncio
import logging
from collections import defaultdict
from typing import Any, Callable

from distributed_tpu_torch import config
from distributed_tpu_torch.exceptions import CommClosedError
from distributed_tpu_torch.protocol.serialize import Serialize, unwrap
from distributed_tpu_torch.shuffle.buffers import (
    CommShardsBuffer,
    DiskShardsBuffer,
    MemoryShardsBuffer,
    ResourceLimiter,
    ShuffleClosedError,
)

logger = logging.getLogger("distributed_tpu_torch.shuffle")


class ShuffleSpec:
    """Declarative description of one shuffle run (reference
    shuffle/_core.py:421).  Created by the scheduler extension; run_id is
    the fencing epoch."""

    __slots__ = ("id", "run_id", "npartitions_out", "n_inputs", "worker_for",
                 "device_owned")

    def __init__(self, id: str, run_id: int, npartitions_out: int,
                 worker_for: dict[int, str], n_inputs: int | None = None,
                 device_owned: bool = False):
        self.id = id
        self.run_id = run_id
        self.npartitions_out = npartitions_out
        # worker_for pins partitions to pod device owners (multi-host
        # device plane): the barrier then fans the exchange out SPMD
        self.device_owned = bool(device_owned)
        # input-partition count is independent of the output fan-out
        # (n_in != n_out shuffles); consumers that need "how many
        # registrations complete the exchange" must use this, never
        # npartitions_out
        self.n_inputs = n_inputs if n_inputs is not None else npartitions_out
        self.worker_for = dict(worker_for)

    @property
    def participants(self) -> list[str]:
        return sorted(set(self.worker_for.values()))

    def to_msg(self) -> dict:
        return {
            "id": self.id,
            "run_id": self.run_id,
            "npartitions_out": self.npartitions_out,
            "n_inputs": self.n_inputs,
            "device_owned": self.device_owned,
            "worker_for": {str(k): v for k, v in self.worker_for.items()},
        }

    @classmethod
    def from_msg(cls, msg: dict) -> "ShuffleSpec":
        return cls(
            msg["id"], msg["run_id"], msg["npartitions_out"],
            {int(k): v for k, v in msg["worker_for"].items()},
            n_inputs=msg.get("n_inputs"),
            device_owned=msg.get("device_owned", False),
        )


class ShuffleRun:
    """Per-worker engine for one (id, run_id) (reference shuffle/_core.py:62)."""

    def __init__(self, spec: ShuffleSpec, worker: Any, *,
                 use_disk: bool | None = None,
                 memory_limit: int | None = None):
        self.spec = spec
        self.worker = worker
        self.inputs_done = asyncio.Event()
        self.closed = False
        # pipelined push plane: dedicated comm + serializing lock +
        # unacked-window counter per peer
        self._push_comms: dict[str, Any] = {}
        self._push_locks: defaultdict[str, asyncio.Lock] = defaultdict(
            asyncio.Lock
        )
        self._push_unacked: dict[str, int] = {}
        self._push_sent: defaultdict[str, int] = defaultdict(int)
        # built once: the spec message rides only the run-opening push
        # per peer (its worker_for map is O(workers) — at 128 workers,
        # re-walking it per push measurably dominated message handling)
        self._spec_msg = spec.to_msg()
        self.bytes_received = 0
        self.transfers_done: set[int] = set()
        self.outputs_served: set[int] = set()
        self.local_outputs_left = sum(
            1 for addr in spec.worker_for.values() if addr == worker.address
        )
        if use_disk is None:
            use_disk = bool(config.get("shuffle.disk"))
        if memory_limit is None:
            memory_limit = config.parse_bytes(config.get("shuffle.memory-limit"))
        self.limiter = ResourceLimiter(memory_limit)
        if use_disk:
            import tempfile

            directory = tempfile.mkdtemp(
                prefix=f"dtpu-shuffle-{spec.id}-r{spec.run_id}-"
            )
            self.store: Any = DiskShardsBuffer(directory, limiter=self.limiter)
        else:
            self.store = MemoryShardsBuffer(limiter=self.limiter)
        self.comms = CommShardsBuffer(
            send=self._send_to_peer,
            limiter=ResourceLimiter(memory_limit),
            message_bytes_limit=config.parse_bytes(
                config.get("shuffle.comm-message-bytes")
            ),
        )
        from distributed_tpu_torch.utils.misc import time as _now

        self.last_activity = _now()

    def touch(self) -> None:
        from distributed_tpu_torch.utils.misc import time as _now

        self.last_activity = _now()

    @property
    def id(self) -> str:
        return self.spec.id

    @property
    def run_id(self) -> int:
        return self.spec.run_id

    # ---------------------------------------------------------- data plane
    #
    # Pushes are PIPELINED one-way writes on a dedicated comm per peer:
    # the request-response-per-push design paid a full RPC round trip
    # for every (sender, receiver) pair — at 128x128 partitions that is
    # 16k round trips of pure control latency (measured: 86% of the
    # config-4 wall).  The server processes messages on one comm
    # strictly in order, so a single ``shuffle_receive_flush``
    # request-response at barrier time confirms every prior push on
    # that comm AND carries any deferred error (stale epoch, receive
    # failure).  Backpressure: a window of unacked pushes per peer
    # forces a flush round trip, and on TCP the receiver's blocked
    # handler propagates to the sender's write.

    PUSH_WINDOW = 16

    async def _push_comm(self, addr: str):
        comm = self._push_comms.get(addr)
        if comm is None or comm.closed:
            if self._push_unacked.get(addr, 0) > 0:
                # the comm died with pushes written but unconfirmed:
                # they may be lost, and the receiver's processed count
                # could never reach our sent count — fail the epoch NOW
                # instead of stalling the barrier to its timeout
                raise ShuffleClosedError(
                    f"{self.id}: push comm to {addr} died with "
                    f"{self._push_unacked[addr]} unconfirmed pushes"
                )
            from distributed_tpu_torch.comm.core import connect

            comm = await connect(addr, **self.worker.connection_args)
            self._push_comms[addr] = comm
            self._push_unacked[addr] = 0
        return comm

    async def _push_flush_one(self, addr: str, comm: Any) -> None:
        """One flush round trip confirming every prior push on ``comm``."""
        await comm.write({
            "op": "shuffle_receive_flush",
            "id": self.id, "run_id": self.run_id, "reply": True,
        })
        resp = await comm.read()
        self._push_unacked[addr] = 0
        if resp.get("status") == "stale":
            raise ShuffleClosedError(
                f"{self.id} run {self.run_id} superseded on {addr}"
            )
        if resp.get("status") != "OK":
            raise RuntimeError(f"shuffle push failed on {addr}: {resp!r}")

    async def _send_to_peer(self, addr: str, shards: list) -> None:
        """CommShardsBuffer drain target: one batched push to one peer.
        ``shards`` is a list of (output_partition, tag, shard)."""
        by_output: defaultdict[int, list] = defaultdict(list)
        for j, tag, shard in shards:
            by_output[j].append((tag, shard))
        lock = self._push_locks[addr]
        async with lock:
            comm = await self._push_comm(addr)
            msg = {
                "op": "shuffle_receive",
                "id": self.id, "run_id": self.run_id,
                "shards": Serialize(dict(by_output)),
                "sender": self.worker.address,
                "reply": False,
            }
            if not self._push_sent[addr]:
                # run-opening push on this comm: carry the spec so a
                # cold receiver can build the run without a scheduler
                # round trip (in-order delivery per comm guarantees it
                # arrives first); later pushes stay lean
                msg["spec"] = self._spec_msg
            await comm.write(msg)
            self._push_sent[addr] += 1
            self._push_unacked[addr] += 1
            if self._push_unacked[addr] >= self.PUSH_WINDOW:
                await self._push_flush_one(addr, comm)

    async def add_partition(self, data: Any, partition_id: int,
                            splitter: Callable) -> int:
        """Split one input partition and push shards to their owners
        (reference shuffle/_core.py:331)."""
        if self.closed:
            raise ShuffleClosedError(self.id)
        self.touch()
        out_shards = splitter(data, self.spec.npartitions_out)
        local: defaultdict[int, list] = defaultdict(list)
        remote: defaultdict[str, list] = defaultdict(list)
        for j, shard in out_shards.items():
            j = int(j) % self.spec.npartitions_out
            addr = self.spec.worker_for[j]
            if addr == self.worker.address:
                local[j].append((partition_id, shard))
            else:
                remote[addr].append((j, partition_id, shard))
        if local:
            await self.receive(dict(local))
        if remote:
            await self.comms.write(dict(remote))
        self.transfers_done.add(partition_id)
        return partition_id

    async def receive(self, shards: dict) -> None:
        """Accept shards pushed by a peer: drain into the spill store
        (reference shuffle/_core.py:260)."""
        if self.closed:
            raise ShuffleClosedError(self.id)
        self.touch()
        data = {int(j): list(tagged) for j, tagged in shards.items()}
        # the store's write sizes every shard for its limiter booking —
        # reuse that instead of a second full sizeof walk
        self.bytes_received += await self.store.write(data)

    async def barrier(self) -> None:
        """All inputs transferred: route the barrier through the scheduler
        extension, which broadcasts inputs_done to EVERY participating
        worker (transfer-only ones included) and waits for each to flush
        its outbound shards before acknowledging (reference
        shuffle/_core.py:190, _scheduler_plugin.py:95).  Flushing only our
        own comms here would race unpack against other workers' in-flight
        shards."""
        await self.comms.flush()  # local head start; scheduler re-flushes
        try:
            resp = await self.worker.rpc(
                self.worker.scheduler_addr
            ).shuffle_barrier(id=self.id, run_id=self.run_id)
        except (CommClosedError, OSError) as e:
            raise RuntimeError("barrier could not reach scheduler") from e
        status = resp.get("status")
        if status == "stale":
            raise ShuffleClosedError(
                f"{self.id} run {self.run_id} superseded by {resp.get('run_id')}"
            )
        if status != "OK":
            raise ShuffleClosedError(
                f"{self.id} barrier failed: {resp.get('error', status)}"
            )

    async def collect_output(self, j: int, timeout: float = 30.0) -> list:
        """The deduped, tag-ordered shard list for output partition j
        (reference shuffle/_core.py:353).  Serves each partition exactly
        once: a second request means a recomputed unpack would get an
        empty partition, so the run fails for an epoch restart instead."""
        self.touch()
        if not self.inputs_done.is_set():
            # about to block on EXTERNAL progress (the barrier needs every
            # transfer to finish): leave the execution slot first, or a
            # dep-free recomputed unpack wedges a 1-thread worker whose
            # queue holds the very transfer the barrier is waiting for
            # (measured deadlock-until-timeout under epoch restarts)
            try:
                from distributed_tpu_torch.client.worker_client import secede

                secede()
            except ValueError:
                pass  # rpc handler path (shuffle_fetch_output): no task slot
            await asyncio.wait_for(self.inputs_done.wait(), timeout)
        self.touch()
        if j in self.outputs_served:
            raise ShuffleClosedError(
                f"{self.id}: output partition {j} already served; "
                f"restart required"
            )
        self.outputs_served.add(j)
        tagged = await self.store.read(j)
        # dedupe by source tag: a transfer that ran twice (worker retry)
        # appended its shards twice; last write wins
        bucket: dict[Any, Any] = {}
        for tag, shard in tagged:
            bucket[tag] = shard
        self.local_outputs_left -= 1
        if self.local_outputs_left <= 0:
            self.worker.shuffle.schedule_cleanup(self.id, self.run_id)
        return [bucket[tag] for tag in sorted(bucket)]

    async def get_output_partition(self, j: int, assembler: Callable,
                                   timeout: float = 30.0) -> Any:
        """Assemble output partition j, fetching from its owner when this
        worker is not it (a recomputed unpack may have lost its worker
        restriction — reference pins unpacks via _set_restriction,
        _scheduler_plugin.py:281; the fetch fallback keeps mis-placed
        recomputes correct instead of silently empty)."""
        owner = self.spec.worker_for.get(int(j) % self.spec.npartitions_out)
        if owner == self.worker.address or owner is None:
            return assembler(await self.collect_output(j, timeout))
        resp = await self.worker.rpc(owner).shuffle_fetch_output(
            id=self.id, run_id=self.run_id, j=int(j)
        )
        if resp.get("status") != "OK":
            raise ShuffleClosedError(
                f"{self.id}: owner {owner} cannot serve partition {j}: "
                f"{resp.get('status')}"
            )
        return assembler(unwrap(resp["shards"]))

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        for buf in (self.store, self.comms):
            self.worker._ongoing_background_tasks.call_soon(buf.close)
        for comm in self._push_comms.values():
            if not comm.closed:
                comm.abort()
        self._push_comms.clear()
        self._push_unacked.clear()


class ShuffleWorkerExtension:
    """Caches active runs by (id, run_id); fences stale epochs; fetches
    authoritative specs from the scheduler extension
    (reference shuffle/_worker_plugin.py:36)."""

    def __init__(self, worker: Any):
        self.worker = worker
        self.runs: dict[str, ShuffleRun] = {}  # id -> newest run
        self.RUN_TTL = config.parse_timedelta(config.get("shuffle.run-ttl"))
        # deferred outcomes of ONE-WAY pushes (reply=False messages have
        # nowhere to report): the sender's shuffle_receive_flush round
        # trip picks them up.  Bounded: epochs are short-lived.
        self._push_errors: dict[tuple[str, int], str] = {}
        # pushes PROCESSED per (id, run_id, sender): the barrier's
        # wait_pushes compares these against the senders' reported
        # counts — scheduler-aggregated confirmation instead of a flush
        # round trip per (sender, receiver) pair
        self._push_processed: defaultdict[tuple[str, int, str], int] = (
            defaultdict(int)
        )
        self._push_event = asyncio.Event()
        worker.handlers["shuffle_receive"] = self.shuffle_receive
        worker.handlers["shuffle_receive_flush"] = self.shuffle_receive_flush
        worker.handlers["shuffle_wait_pushes"] = self.shuffle_wait_pushes
        worker.handlers["shuffle_inputs_done"] = self.shuffle_inputs_done
        worker.handlers["shuffle_fetch_output"] = self.shuffle_fetch_output
        worker.handlers["device_shuffle_exchange"] = self.device_exchange
        worker.handlers["device_shuffle_precheck"] = self.device_precheck

    async def device_precheck(self, id: str = "", run_id: int = 0) -> dict:
        from distributed_tpu_torch.shuffle.device import (
            device_shuffle_precheck_handler,
        )

        return await device_shuffle_precheck_handler(
            self.worker, id=id, run_id=run_id
        )

    async def device_exchange(self, id: str = "", run_id: int = 0,
                              max_n: int = 0) -> dict:
        """Join a device-plane exchange epoch with this process's local
        shards (multi-host SPMD; shuffle/device.py)."""
        from distributed_tpu_torch.shuffle.device import (
            device_shuffle_exchange_handler,
        )

        return await device_shuffle_exchange_handler(
            self.worker, id=id, run_id=run_id, max_n=max_n
        )

    def get_or_create(self, spec: ShuffleSpec) -> ShuffleRun:
        run = self.runs.get(spec.id)
        if run is not None:
            if run.run_id > spec.run_id:
                raise ShuffleClosedError(
                    f"{spec.id} run {spec.run_id} superseded by {run.run_id}"
                )
            if run.run_id == spec.run_id:
                run.touch()
                return run
            run.close()  # stale epoch: replace
        run = self.runs[spec.id] = ShuffleRun(spec, self.worker)
        # TTL backstop: runs whose outputs are never unpacked (transfer-only
        # workers, cancelled shuffles) must not accumulate forever
        self.schedule_cleanup(spec.id, spec.run_id, delay=self.RUN_TTL)
        return run

    async def get_or_create_remote(self, shuffle_id: str) -> ShuffleRun:
        """Authoritative path for task bodies: ask the scheduler for the
        CURRENT epoch's spec (a restarted shuffle has a bumped run_id)."""
        resp = await self.worker.rpc(self.worker.scheduler_addr).shuffle_get_run(
            id=shuffle_id, worker=self.worker.address
        )
        if resp.get("status") != "OK":
            raise ShuffleClosedError(
                f"scheduler does not know shuffle {shuffle_id}: {resp!r}"
            )
        return self.get_or_create(ShuffleSpec.from_msg(resp["spec"]))

    def _get_checked(self, id: str, run_id: int) -> ShuffleRun | None:
        run = self.runs.get(id)
        if run is None or run.run_id != run_id:
            return None
        return run

    # ------------------------------------------------------------ handlers

    async def shuffle_receive(self, id: str = "", run_id: int = 0,
                              spec: dict | None = None,
                              shards: Any = None,
                              sender: str = "") -> dict:
        """Accept a shard push.  Request-response callers read the
        status directly; pipelined one-way pushes (reply=False) get
        their non-OK outcomes recorded for shuffle_receive_flush."""
        def _fail(status: str) -> dict:
            self._push_errors[(id, run_id)] = status
            return {"status": status, "id": id, "run_id": run_id}

        try:
            run = self.runs.get(id)
            if run is not None and run.run_id > run_id:
                return _fail("stale")
            if run is None or run.run_id < run_id:
                # first contact for this (id, run_id): build the run
                # from the spec riding on the run-opening push, or — if
                # this push raced ahead of it (reconnected comm) — from
                # the scheduler
                if spec is not None:
                    run = self.get_or_create(ShuffleSpec.from_msg(spec))
                else:
                    try:
                        run = await self.get_or_create_remote(id)
                    except Exception:
                        return _fail("unknown-run")
                    if run.run_id > run_id:
                        return _fail("stale")
                    if run.run_id < run_id:
                        return _fail("unknown-run")
            await run.receive(unwrap(shards))
        except ShuffleClosedError:
            return _fail("stale")
        except Exception as exc:
            # one-way pushes (reply=False) have NOWHERE to report: an
            # exception escaping to the rpc loop is silently dropped and
            # the barrier would only see a 60s wait_pushes timeout.
            # Record the real cause for the flush/wait round instead.
            logger.exception("shuffle push failed (%s run %s)", id, run_id)
            return _fail(f"receive-failed: {exc!r}"[:300])
        if sender:
            self._push_processed[(id, run_id, sender)] += 1
            self._push_event.set()
        return {"status": "OK"}

    async def shuffle_wait_pushes(self, id: str = "", run_id: int = 0,
                                  expected: dict | None = None,
                                  timeout: float = 60.0) -> dict:
        """Barrier confirmation: wait until this worker has PROCESSED
        at least ``expected[sender]`` pushes from each sender (their
        self-reported counts, aggregated by the scheduler).  One RPC per
        receiver replaces a flush round trip per (sender, receiver)
        pair — 16k round trips became 2 per worker at 128x128."""
        expected = expected or {}
        deadline = asyncio.get_event_loop().time() + timeout
        while True:
            err = self._push_errors.get((id, run_id))
            if err is not None:
                return {"status": err, "id": id, "run_id": run_id}
            run = self.runs.get(id)
            if run is not None and run.run_id > run_id:
                return {"status": "stale", "id": id, "run_id": run_id}
            missing = {
                s: n for s, n in expected.items()
                if self._push_processed[(id, run_id, s)] < n
            }
            if not missing:
                return {"status": "OK"}
            if asyncio.get_event_loop().time() > deadline:
                return {"status": "timeout", "missing": missing}
            self._push_event.clear()
            try:
                await asyncio.wait_for(
                    self._push_event.wait(),
                    max(deadline - asyncio.get_event_loop().time(), 0.01),
                )
            except asyncio.TimeoutError:
                pass

    async def shuffle_receive_flush(self, id: str = "",
                                    run_id: int = 0) -> dict:
        """Settle a peer's pipelined pushes: the server processes one
        comm's messages in order, so by the time this runs every prior
        push on the same comm has been handled — report any deferred
        failure, or staleness discovered since."""
        err = self._push_errors.get((id, run_id))
        if err is not None:
            return {"status": err, "id": id, "run_id": run_id}
        run = self.runs.get(id)
        if run is not None and run.run_id > run_id:
            return {"status": "stale", "id": id, "run_id": run_id}
        return {"status": "OK"}

    async def shuffle_fetch_output(self, id: str = "", run_id: int = 0,
                                   j: int = 0) -> dict:
        """Serve an output partition's shards to a mis-placed unpack."""
        run = self._get_checked(id, run_id)
        if run is None:
            return {"status": "stale", "id": id, "run_id": run_id}
        try:
            shards = await run.collect_output(j)
        except ShuffleClosedError:
            return {"status": "closed", "id": id, "run_id": run_id}
        except asyncio.TimeoutError:
            return {"status": "timeout", "id": id, "run_id": run_id}
        return {"status": "OK", "shards": Serialize(shards)}

    async def shuffle_inputs_done(self, id: str = "", run_id: int = 0,
                                  spec: dict | None = None) -> dict:
        run = self._get_checked(id, run_id)
        if run is None:
            if spec is None:
                return {"status": "stale"}
            try:
                run = self.get_or_create(ShuffleSpec.from_msg(spec))
            except ShuffleClosedError:
                return {"status": "stale"}
        # drain OUR outbound shards onto the wire before acknowledging,
        # and report how many pushes went to each peer: the scheduler
        # aggregates the counts and asks every RECEIVER to confirm
        # processing in ONE wait_pushes RPC (reference _core.py:272
        # flushes inside inputs_done; per-pair flush round trips were
        # 60% of the 128x128 shuffle wall)
        await run.comms.flush()
        run.inputs_done.set()
        return {"status": "OK", "sent": dict(run._push_sent)}

    def schedule_cleanup(self, id: str, run_id: int, delay: float = 30.0) -> None:
        """Forget a run after a grace period; reschedules while active."""

        async def _cleanup() -> None:
            from distributed_tpu_torch.utils.misc import time as _now

            run = self.runs.get(id)
            if run is None or run.run_id != run_id:
                return
            idle = _now() - run.last_activity
            # idleness required even with no local outputs left: a
            # transfer-only worker is still actively pushing shards
            if (run.local_outputs_left <= 0 and idle >= 5.0) or idle >= self.RUN_TTL:
                run.close()
                del self.runs[id]
                # per-epoch push bookkeeping dies with the run, or a
                # long-lived worker leaks one entry per (epoch, sender)
                self._push_errors.pop((id, run_id), None)
                for k in [
                    k for k in self._push_processed
                    if k[0] == id and k[1] <= run_id
                ]:
                    del self._push_processed[k]
                # collect any device-resident run of this epoch too:
                # abandoned epochs must not pin device arrays.  Idle-gated
                # because the device store is process-global while this
                # cleanup fires off ONE worker's host-run idleness — a
                # live exchange other workers are unpacking stays.
                from distributed_tpu_torch.shuffle.device import device_store

                device_store().forget(id, run_id,
                                      only_idle_for=self.RUN_TTL)
            else:
                self.schedule_cleanup(
                    id, run_id, delay=max(self.RUN_TTL - idle, 5.0)
                )

        self.worker._ongoing_background_tasks.call_later(delay, _cleanup)

    def close(self) -> None:
        for run in self.runs.values():
            run.close()
        self.runs.clear()


# ------------------------------------------------------------ splitters

def stable_hash(x: Any) -> int:
    """Process-independent hash: builtin hash() is randomized per
    interpreter for str/bytes, which would route equal keys hashed on
    different workers to different partitions."""
    import hashlib

    if isinstance(x, bool):
        x = repr(x).encode()
    elif isinstance(x, int):
        return x
    if isinstance(x, str):
        x = x.encode()
    elif not isinstance(x, bytes):
        x = repr(x).encode()
    return int.from_bytes(
        hashlib.blake2b(x, digest_size=8).digest(), "big"
    )


def split_records_by_hash(data: Any, npartitions: int) -> dict[int, list]:
    """Generic record splitter: hash each record (or its key for
    (key, value) pairs is the caller's concern) into an output partition."""
    out: defaultdict[int, list] = defaultdict(list)
    for rec in data:
        out[stable_hash(rec) % npartitions].append(rec)
    return dict(out)


def make_keyed_splitter(key: Callable) -> Callable:
    def splitter(data: Any, npartitions: int) -> dict[int, list]:
        out: defaultdict[int, list] = defaultdict(list)
        for rec in data:
            out[stable_hash(key(rec)) % npartitions].append(rec)
        return dict(out)

    return splitter


def concat_records(shards: list) -> list:
    out: list = []
    for shard in shards:
        out.extend(shard)
    return out
