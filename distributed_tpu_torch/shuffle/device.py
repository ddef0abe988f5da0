"""Device-resident P2P shuffle, PyTorch + CUDA port.

The counterpart of ``distributed_tpu/shuffle/device.py``: partitions of
``(keys, values)`` tensors stay on their shards' devices, the exchange is
one :func:`~distributed_tpu_torch.ops.ici.shuffle_on_mesh` (kernel K12 and
the comm interface's ``all_to_all``), and the host carries only control:
run specs, epoch fencing, the barrier and the counts.

- :class:`DeviceRun`: the partitions of one ``(id, run_id)`` epoch and its
  one exchange.  Ragged lengths are padded to ``max_n`` and masked out with
  ``valid``, the capacity is ``max_n``, and output ``d`` is the valid rows
  from every source, in source order, on shard ``d``'s device.
- :class:`DeviceShuffleStore`: the process-wide registry of runs, with the
  reference's rules (epoch fencing, the stale ``run_id`` drop, the bounded
  ``_max_run``, ``was_served_once``, ``forget(only_idle_for=)``,
  ``mark_served`` dropping the inputs).
- The task bodies (transfer, barrier, unpack), the precheck and exchange
  RPC handlers (which the worker's ``ShuffleWorkerExtension`` registers)
  and the graph function :func:`p2p_shuffle_device`.  As in the reference,
  a body finds its worker through ``get_worker()`` and the current epoch
  through ``worker.shuffle.get_or_create_remote``; a stale epoch raises
  the port's ``Reschedule``.

Where the port differs from the reference (each has a test in
``tests/test_torch_shuffle_device.py``): the store's ``devices`` is the one
place that sets the mesh's devices.  ``None`` (the default) is the
visible CUDA devices, one a shard, and raises without a card; a single
card runs the 8 shards of a mesh as ``device_store().devices = ["cuda:0"]
* 8``, and the CPU as ``["cpu"] * 8``.  The reference's mesh is
``jax.devices()``.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time as _time
import uuid
from collections import deque
from typing import Any

import torch

from distributed_tpu_torch.exceptions import Reschedule
from distributed_tpu_torch.ops.comm import LocalShards, ProcessGroupShards
from distributed_tpu_torch.ops.ici import make_mesh_1d, shuffle_on_mesh
from distributed_tpu_torch.parallel.multihost import is_multihost, local_device_indices

logger = logging.getLogger("distributed_tpu_torch.shuffle")


class DeviceRun:
    """Per-(id, run_id) device-shard registry + one-shot exchange.

    ``devices``: each mesh shard's device (may repeat one card or the
    CPU); None means the visible CUDA devices, one a shard."""

    def __init__(self, id: str, run_id: int, n_inputs: int, npartitions_out: int,
                 devices=None):
        self.id = id
        self.run_id = run_id
        self.n_inputs = n_inputs
        self.npartitions_out = npartitions_out
        self.devices = devices
        self.parts: dict[int, tuple[Any, Any]] = {}
        self.outputs: dict[int, tuple[torch.Tensor, torch.Tensor]] | None = None
        self.local_ids: list[int] = []
        self.served: set[int] = set()
        self.last_activity = _time.monotonic()
        self.lock = threading.Lock()

    def touch(self) -> None:
        self.last_activity = _time.monotonic()

    def register(self, pid: int, keys: Any, values: Any) -> None:
        with self.lock:
            self.touch()
            self.parts[int(pid)] = (keys, values)

    def _mesh_and_comm(self, n_dev: int):
        if is_multihost():
            # one shard a rank: this rank's entry is its own card
            devices = self.devices or [torch.device("cuda", torch.cuda.current_device())] * n_dev
            mesh = make_mesh_1d(n_dev, devices=devices)
            return mesh, ProcessGroupShards(mesh)
        mesh = make_mesh_1d(n_dev, devices=self.devices)
        return mesh, LocalShards(mesh)

    def exchange(self, max_n: int | None = None) -> None:
        """Run the exchange once; idempotent per epoch.

        This process contributes the shards it owns (all of them in one
        process; its rank's in a process group, where every rank must call
        this together) and keeps the outputs of those shards.  ``max_n``:
        the global longest partition (the barrier's, from the transfer
        results); the ragged lengths are padded to it and masked, so no
        padding row is exchanged."""
        with self.lock:
            self.touch()
            if self.outputs is not None:
                return
            n_dev = self.n_inputs
            local_ids = local_device_indices(n_dev)
            if not local_ids and not self.parts:
                # owns no shard and holds no registration: nothing to add,
                # and outputs stay None so a stray unpack restarts the epoch
                self.local_ids = []
                return
            if set(self.parts) != set(local_ids):
                raise RuntimeError(
                    f"device shuffle {self.id} run {self.run_id}: registered partitions "
                    f"{sorted(self.parts)} != local mesh devices {local_ids}")
            mesh, comm = self._mesh_and_comm(n_dev)
            if max_n is None:
                max_n = max((int(k.shape[0]) for k, _ in self.parts.values()), default=1)
            max_n = max(int(max_n), 1)
            k_shards, v_shards, m_shards = [], [], []
            for d in local_ids:
                keys, values = self.parts[d]
                dev = mesh.devices[d]
                # a partition already on its device moves nothing
                keys = torch.as_tensor(keys).to(dev, torch.int32)
                values = torch.as_tensor(values).to(dev)
                n = int(keys.shape[0])
                pad = max_n - n
                if pad:
                    keys = torch.cat([keys, keys.new_zeros(pad)])
                    values = torch.cat([values, values.new_zeros((pad, *values.shape[1:]))])
                k_shards.append(keys)
                v_shards.append(values)
                m_shards.append(torch.arange(max_n, device=dev) < n)
            ko, vo, counts, _sent = shuffle_on_mesh(
                mesh, k_shards, v_shards, capacity=max_n, valid=m_shards, comm=comm)
            outputs = {}
            for j, d in enumerate(local_ids):
                # the counts are control data: the only bytes that reach the host
                cnt = counts[j].cpu().tolist()
                if max(cnt, default=0) > max_n:  # pragma: no cover - capacity is max_n
                    raise RuntimeError("device shuffle truncated a block")
                outputs[d] = (torch.cat([ko[j][s, : cnt[s]] for s in range(n_dev)]),
                              torch.cat([vo[j][s, : cnt[s]] for s in range(n_dev)]))
            self.outputs = outputs
            self.local_ids = list(local_ids)


class DeviceShuffleStore:
    """Process-level registry of device runs.  ``devices`` is what every
    new run's mesh is built on (None: the visible CUDA devices)."""

    def __init__(self, devices=None) -> None:
        self.devices = devices
        self.runs: dict[tuple[str, int], DeviceRun] = {}
        # epochs fully served and collected: a straggling duplicate task
        # must not resurrect an empty run that pins device memory
        self.done: deque[tuple[str, int]] = deque(maxlen=256)
        self._done_set: set[tuple[str, int]] = set()
        # newest epoch ever seen per shuffle id (bounded, insertion-ordered):
        # a straggler with an older run_id must not re-create a dead epoch
        self._max_run: dict[str, int] = {}
        self._max_run_cap = 4096
        # served epochs that already absorbed one duplicate-unpack reschedule
        self._served_rescheduled: set[tuple[str, int, int]] = set()
        self.lock = threading.Lock()

    def get_or_create(self, id: str, run_id: int, n_inputs: int,
                      npartitions_out: int) -> DeviceRun | None:
        """The live run for this epoch, or None when the epoch already
        completed or was superseded by a newer one."""
        with self.lock:
            if (id, run_id) in self._done_set:
                return None
            if run_id < self._max_run.get(id, -1):
                return None
            run = self.runs.get((id, run_id))
            if run is None:
                run = self.runs[(id, run_id)] = DeviceRun(
                    id, run_id, n_inputs, npartitions_out, devices=self.devices)
                self._max_run.pop(id, None)  # re-insert at the newest position
                self._max_run[id] = run_id
                while len(self._max_run) > self._max_run_cap:
                    del self._max_run[next(iter(self._max_run))]
                for key in [k for k in self.runs if k[0] == id and k[1] < run_id]:
                    del self.runs[key]
            return run

    def was_served(self, id: str, run_id: int) -> bool:
        """True when this epoch finished and was collected."""
        with self.lock:
            return (id, run_id) in self._done_set

    def was_served_once(self, id: str, run_id: int, pid: int) -> bool:
        """True the first time a finished epoch sees a duplicate unpack of
        partition ``pid`` (reschedule); False after that (restart)."""
        with self.lock:
            if (id, run_id) not in self._done_set:
                return False
            tag = (id, run_id, int(pid))
            if tag in self._served_rescheduled:
                return False
            self._served_rescheduled.add(tag)
            return True

    def forget(self, id: str, run_id: int | None = None,
               only_idle_for: float | None = None) -> None:
        """Collect runs of ``id`` (all epochs, or those <= ``run_id``),
        skipping runs touched less than ``only_idle_for`` seconds ago."""
        now = _time.monotonic()
        with self.lock:
            for key in [
                k for k, r in self.runs.items()
                if k[0] == id and (run_id is None or k[1] <= run_id)
                and (only_idle_for is None or now - r.last_activity >= only_idle_for)
            ]:
                del self.runs[key]

    def mark_served(self, run: DeviceRun, pid: int) -> None:
        """Drop the inputs at the first unpack, and the run once every local
        output was unpacked."""
        with self.lock:
            run.touch()
            run.served.add(int(pid))
            run.parts.clear()
            n_local = len(run.local_ids) or run.npartitions_out
            if len(run.served) >= n_local:
                self.runs.pop((run.id, run.run_id), None)
                key = (run.id, run.run_id)
                if key not in self._done_set:
                    if len(self.done) == self.done.maxlen:
                        self._done_set.discard(self.done[0])
                    self.done.append(key)
                    self._done_set.add(key)


async def _run_in_daemon_thread(fn, *args):
    """Run a call that may block for good (a collective whose peers never
    arrive) on a throwaway daemon thread, off the event loop."""
    loop = asyncio.get_running_loop()
    done = asyncio.Event()
    box: list = []

    def run():
        try:
            box.append((True, fn(*args)))
        except BaseException as exc:  # noqa: BLE001 - relayed to the awaiter
            box.append((False, exc))
        try:
            loop.call_soon_threadsafe(done.set)
        except RuntimeError:
            pass

    threading.Thread(target=run, daemon=True, name="dtpu-torch-device-exchange").start()
    await done.wait()
    ok, val = box[0]
    if not ok:
        raise val
    return val


_store: DeviceShuffleStore | None = None


def device_store() -> DeviceShuffleStore:
    global _store
    if _store is None:
        _store = DeviceShuffleStore()
    return _store


# ------------------------------------------------------------ task bodies


async def _spec_for(shuffle_id: str):
    from distributed_tpu_torch.worker.context import get_worker

    worker = get_worker()
    run = await worker.shuffle.get_or_create_remote(shuffle_id)
    return worker, run


async def device_shuffle_transfer(data: Any, shuffle_id: str,
                                  partition_id: int) -> tuple[int, int]:
    """Register one device partition; no data moves.  Returns
    ``(partition_id, n_rows)`` for the barrier's global ``max_n``."""
    _worker, run = await _spec_for(shuffle_id)
    keys, values = data
    store_run = device_store().get_or_create(
        shuffle_id, run.run_id, run.spec.n_inputs, run.spec.npartitions_out)
    if store_run is not None:  # None: a duplicate of a finished epoch
        store_run.register(partition_id, keys, values)
    return int(partition_id), int(keys.shape[0])


async def device_shuffle_exchange_handler(worker: Any, id: str = "", run_id: int = 0,
                                          max_n: int = 0) -> dict:
    """Worker RPC: enter this epoch's exchange with this process's shards."""
    run = await worker.shuffle.get_or_create_remote(id)
    if run.run_id != run_id:
        return {"status": "stale", "run_id": run.run_id}
    store_run = device_store().get_or_create(id, run_id, run.spec.n_inputs,
                                             run.spec.npartitions_out)
    if store_run is None:
        return {"status": "done"}
    await _run_in_daemon_thread(store_run.exchange, max_n)
    return {"status": "OK"}


async def device_shuffle_precheck_handler(worker: Any, id: str = "", run_id: int = 0) -> dict:
    """Worker RPC: is this process on the same epoch with its partitions
    registered?  Does not enter the collective."""
    run = await worker.shuffle.get_or_create_remote(id)
    if run.run_id != run_id:
        return {"status": "stale", "run_id": run.run_id}
    if device_store().was_served(id, run_id):
        return {"status": "done"}
    store_run = device_store().runs.get((id, run_id))
    if store_run is None:
        return {"status": "no-parts"}
    return {"status": "OK", "n_parts": len(store_run.parts)}


async def device_shuffle_barrier(shuffle_id: str, *transfer_results) -> int:
    """Scheduler-fenced barrier, then the exchange: one call in one
    process; in a process group, a precheck round on every participant and
    then the exchange fanned out to all of them together."""
    worker, run = await _spec_for(shuffle_id)
    await run.barrier()
    max_n = max((int(n) for _, n in transfer_results), default=1)
    participants = set(run.spec.worker_for.values())
    if is_multihost() and not run.spec.device_owned and len(participants) > 1:
        raise RuntimeError(
            "device shuffle across processes requires device-owned placement: one worker "
            "process a shard, so that ownership is disjoint (got round-robin worker_for)")
    if is_multihost() and run.spec.device_owned:
        timeout = 120.0

        async def call(addr: str, op: str):
            if addr == worker.address:
                if op == "exchange":
                    return await device_shuffle_exchange_handler(
                        worker, id=shuffle_id, run_id=run.run_id, max_n=max_n)
                return await device_shuffle_precheck_handler(worker, id=shuffle_id,
                                                             run_id=run.run_id)
            peer = worker.rpc(addr)
            if op == "exchange":
                return await peer.device_shuffle_exchange(id=shuffle_id, run_id=run.run_id,
                                                          max_n=max_n)
            return await peer.device_shuffle_precheck(id=shuffle_id, run_id=run.run_id)

        addrs = sorted(participants)
        pre = await asyncio.wait_for(asyncio.gather(*(call(a, "precheck") for a in addrs)),
                                     timeout)
        if any(r.get("status") == "done" for r in pre):
            return run.run_id
        bad = [(a, r) for a, r in zip(addrs, pre) if r.get("status") != "OK"]
        if bad:
            raise RuntimeError(f"device exchange precheck failed: {bad!r}")
        results = await asyncio.wait_for(
            asyncio.gather(*(call(a, "exchange") for a in addrs)), timeout)
        bad = [r for r in results if r.get("status") not in ("OK", "done")]
        if bad:
            raise RuntimeError(f"device exchange failed: {bad!r}")
        return run.run_id
    store_run = device_store().get_or_create(shuffle_id, run.run_id, run.spec.n_inputs,
                                             run.spec.npartitions_out)
    if store_run is not None:  # None: a duplicate of a finished epoch
        await _run_in_daemon_thread(store_run.exchange, max_n)
    return run.run_id


async def device_shuffle_unpack(shuffle_id: str, partition_id: int, barrier_result: int) -> Any:
    """Output partition ``partition_id`` as device-resident (keys, values)."""
    worker, run = await _spec_for(shuffle_id)
    store_run = device_store().runs.get((shuffle_id, run.run_id))
    if store_run is None or store_run.outputs is None:
        if device_store().was_served_once(shuffle_id, run.run_id, partition_id):
            # a duplicate of a finished epoch: its outputs are in worker
            # memory, a reschedule is enough (once; a second miss restarts)
            raise Reschedule(f"shuffle {shuffle_id} run {run.run_id} already served")
        # the epoch raced past us (a restart, or the run was collected):
        # ask for a fresh epoch and reschedule, as the host bodies do
        from distributed_tpu_torch.shuffle.api import _restart_and_reschedule

        await _restart_and_reschedule(worker, shuffle_id, run.run_id)
    out = store_run.outputs[int(partition_id)]
    device_store().mark_served(store_run, partition_id)
    return out


# ------------------------------------------------------------- the graph


async def p2p_shuffle_device(client: Any, inputs: list) -> list:
    """Hash-shuffle device-resident ``(keys i32 [N_i], values [N_i, ...])``
    partitions, one future a mesh shard; returns the futures of the
    outputs, output ``d`` holding every row with ``mix32(key) % n == d`` on
    shard ``d``'s device."""
    from distributed_tpu_torch.graph.spec import Graph, TaskRef, TaskSpec
    from distributed_tpu_torch.shuffle.api import _create_shuffle

    n = len(inputs)
    shuffle_id = f"devshuffle-{uuid.uuid4().hex[:12]}"
    worker_for, device_owned = await _create_shuffle(client, shuffle_id, n, n, device=True)

    g = Graph()
    transfer_keys = []
    annotations: dict = {}
    for i, fut in enumerate(inputs):
        k = f"{shuffle_id}-transfer-{i}"
        g.tasks[k] = TaskSpec(device_shuffle_transfer, (TaskRef(fut.key), shuffle_id, i))
        if device_owned:
            # one process a shard: partition i registers in the process that
            # owns shard i, so no shard leaves its device
            annotations[k] = {"workers": [worker_for[i]]}
        transfer_keys.append(k)
    barrier_key = f"{shuffle_id}-barrier"
    g.tasks[barrier_key] = TaskSpec(
        device_shuffle_barrier, (shuffle_id, *[TaskRef(k) for k in transfer_keys]))
    unpack_keys = []
    for j in range(n):
        k = f"{shuffle_id}-unpack-{j}"
        g.tasks[k] = TaskSpec(device_shuffle_unpack, (shuffle_id, j, TaskRef(barrier_key)))
        unpack_keys.append(k)
        annotations[k] = {"workers": [worker_for[j]]}
    futs = client._graph_to_futures(dict(g.tasks), unpack_keys, annotations_by_key=annotations)
    return [futs[k] for k in unpack_keys]
