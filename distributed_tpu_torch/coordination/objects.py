"""Client-side coordination objects (reference semaphore.py:250, lock.py:75,
event.py:152, multi_lock.py:138, queues.py:128, variable.py:127,
pubsub.py:201,357).

Each object is a thin async proxy over the scheduler-hosted extension.
They accept either a ``Client`` or anything with a ``scheduler`` rpc
attribute (e.g. a ``Worker``), so tasks running on workers can use them
too.

The port's copy of ``distributed_tpu/coordination/objects.py``, line for
line, through the port's client, ``Future`` and wire.
"""

from __future__ import annotations

import asyncio
import logging
import uuid
from typing import Any

from distributed_tpu_torch.rpc.core import rpc as _rpc

logger = logging.getLogger("distributed_tpu_torch.coordination")


def _scheduler_rpc(obj: Any):
    """Resolve an rpc to the scheduler from a Client/Worker/address."""
    if obj is None:
        raise ValueError("pass a Client (or Worker) to coordination objects")
    if isinstance(obj, str):
        return _rpc(obj)
    sched = getattr(obj, "scheduler", None)
    if sched is not None:
        return sched
    # Worker: rpc pool + known scheduler address
    if hasattr(obj, "scheduler_addr"):
        return obj.rpc(obj.scheduler_addr)
    raise TypeError(f"cannot find a scheduler rpc on {obj!r}")


class Event:
    """Cluster-wide event (reference event.py:152)."""

    def __init__(self, name: str | None = None, client: Any = None):
        self.name = name or f"event-{uuid.uuid4().hex[:12]}"
        self.scheduler = _scheduler_rpc(client)

    async def wait(self, timeout: float | None = None) -> bool:
        return await self.scheduler.event_wait(name=self.name, timeout=timeout)

    async def set(self) -> None:
        await self.scheduler.event_set(name=self.name)

    async def clear(self) -> None:
        await self.scheduler.event_clear(name=self.name)

    async def is_set(self) -> bool:
        return await self.scheduler.event_is_set(name=self.name)

    def __repr__(self) -> str:
        return f"<Event: {self.name!r}>"


class Lock:
    """Cluster-wide mutex (reference lock.py:75)."""

    def __init__(self, name: str | None = None, client: Any = None):
        self.name = name or f"lock-{uuid.uuid4().hex[:12]}"
        self.id = uuid.uuid4().hex
        self.scheduler = _scheduler_rpc(client)
        self._locked = False

    async def acquire(self, timeout: float | None = None) -> bool:
        ok = await self.scheduler.lock_acquire(
            name=self.name, id=self.id, timeout=timeout
        )
        if ok:
            self._locked = True
        return ok

    async def release(self) -> None:
        await self.scheduler.lock_release(name=self.name, id=self.id)
        self._locked = False

    async def locked(self) -> bool:
        return await self.scheduler.lock_locked(name=self.name)

    async def __aenter__(self) -> "Lock":
        await self.acquire()
        return self

    async def __aexit__(self, *exc: Any) -> None:
        await self.release()

    def __repr__(self) -> str:
        return f"<Lock: {self.name!r}>"


class MultiLock:
    """Acquire several named locks atomically (reference multi_lock.py:138)."""

    def __init__(self, names: list[str] = (), client: Any = None):
        self.names = list(names)
        self.id = uuid.uuid4().hex
        self.scheduler = _scheduler_rpc(client)

    async def acquire(self, timeout: float | None = None,
                      num_locks: int | None = None) -> bool:
        return await self.scheduler.multi_lock_acquire(
            locks=self.names, id=self.id, timeout=timeout, num_locks=num_locks
        )

    async def release(self) -> None:
        await self.scheduler.multi_lock_release(id=self.id)

    async def __aenter__(self) -> "MultiLock":
        await self.acquire()
        return self

    async def __aexit__(self, *exc: Any) -> None:
        await self.release()


class Semaphore:
    """Counting semaphore with auto-refreshing leases
    (reference semaphore.py:250)."""

    def __init__(self, max_leases: int = 1, name: str | None = None,
                 client: Any = None):
        self.name = name or f"semaphore-{uuid.uuid4().hex[:12]}"
        self.max_leases = max_leases
        self.scheduler = _scheduler_rpc(client)
        self._leases: list[str] = []
        self._registered: asyncio.Future | None = None
        self._refresh_task: asyncio.Task | None = None

    async def _register(self) -> None:
        await self.scheduler.semaphore_register(
            name=self.name, max_leases=self.max_leases
        )

    def _ensure_refresh(self) -> None:
        if self._refresh_task is None or self._refresh_task.done():
            self._refresh_task = asyncio.create_task(self._refresh_loop())

    async def _refresh_loop(self) -> None:
        while self._leases:
            try:
                await self.scheduler.semaphore_refresh_leases(
                    name=self.name, lease_ids=list(self._leases)
                )
            except asyncio.CancelledError:
                raise
            except Exception:
                # transient comm failure: keep trying — a dead refresh loop
                # would let the scheduler expire a still-held lease
                logger.warning(
                    "semaphore %r lease refresh failed; retrying", self.name
                )
            await asyncio.sleep(5)

    async def acquire(self, timeout: float | None = None) -> bool:
        await self._register()
        lease_id = uuid.uuid4().hex
        ok = await self.scheduler.semaphore_acquire(
            name=self.name, timeout=timeout, lease_id=lease_id
        )
        if ok:
            self._leases.append(lease_id)
            self._ensure_refresh()
        return ok

    async def release(self) -> bool:
        if not self._leases:
            raise ValueError("released too often")
        lease_id = self._leases.pop(0)
        return await self.scheduler.semaphore_release(
            name=self.name, lease_id=lease_id
        )

    async def get_value(self) -> int:
        return await self.scheduler.semaphore_value(name=self.name)

    async def close(self) -> None:
        if self._refresh_task is not None:
            self._refresh_task.cancel()
        await self.scheduler.semaphore_close(name=self.name)

    async def __aenter__(self) -> "Semaphore":
        await self.acquire()
        return self

    async def __aexit__(self, *exc: Any) -> None:
        await self.release()


class Queue:
    """Cluster-wide FIFO queue carrying data or Futures
    (reference queues.py:128)."""

    def __init__(self, name: str | None = None, client: Any = None,
                 maxsize: int = 0):
        self.name = name or f"queue-{uuid.uuid4().hex[:12]}"
        self.client = client
        self.scheduler = _scheduler_rpc(client)
        self.maxsize = maxsize
        self._created = False

    async def _create(self) -> None:
        if not self._created:
            await self.scheduler.queue_create(
                name=self.name, maxsize=self.maxsize
            )
            self._created = True

    async def put(self, value: Any = None, timeout: float | None = None) -> None:
        from distributed_tpu_torch.client.client import Future
        from distributed_tpu_torch.protocol.serialize import Serialize

        await self._create()
        if isinstance(value, Future):
            await self.scheduler.queue_put(
                name=self.name, key=value.key, timeout=timeout
            )
        else:
            await self.scheduler.queue_put(
                name=self.name, value=Serialize(value), timeout=timeout
            )

    async def get(self, timeout: float | None = None) -> Any:
        from distributed_tpu_torch.protocol.serialize import unwrap

        await self._create()
        record = await self.scheduler.queue_get(name=self.name, timeout=timeout)
        return self._unpack(record, unwrap)

    def _unpack(self, record: dict, unwrap: Any) -> Any:
        if record["type"] == "Future":
            from distributed_tpu_torch.client.client import Client, Future

            key = record["value"]
            if isinstance(self.client, Client):
                self.client._ensure_tracked(key)
                return Future(key, self.client)
            return key
        return unwrap(record["value"])

    async def qsize(self) -> int:
        await self._create()
        return await self.scheduler.queue_qsize(name=self.name)

    async def close(self) -> None:
        await self.scheduler.queue_release(name=self.name)


class Variable:
    """Cluster-wide mutable cell (reference variable.py:127)."""

    def __init__(self, name: str | None = None, client: Any = None):
        self.name = name or f"variable-{uuid.uuid4().hex[:12]}"
        self.client = client
        self.scheduler = _scheduler_rpc(client)

    async def set(self, value: Any) -> None:
        from distributed_tpu_torch.client.client import Future
        from distributed_tpu_torch.protocol.serialize import Serialize

        if isinstance(value, Future):
            await self.scheduler.variable_set(name=self.name, key=value.key)
        else:
            await self.scheduler.variable_set(
                name=self.name, value=Serialize(value)
            )

    async def get(self, timeout: float | None = None) -> Any:
        from distributed_tpu_torch.protocol.serialize import unwrap

        record = await self.scheduler.variable_get(
            name=self.name, timeout=timeout
        )
        if record["type"] == "Future":
            from distributed_tpu_torch.client.client import Client, Future

            key = record["value"]
            if isinstance(self.client, Client):
                self.client._ensure_tracked(key)
                return Future(key, self.client)
            return key
        return unwrap(record["value"])

    async def delete(self) -> None:
        await self.scheduler.variable_delete(name=self.name)


class Pub:
    """Publish to a topic (reference pubsub.py:201).  Client-side publishers
    relay through the scheduler stream."""

    def __init__(self, name: str, client: Any = None):
        self.name = name
        self.client = client

    def put(self, msg: Any) -> None:
        from distributed_tpu_torch.client.client import Client

        if isinstance(self.client, Client):
            self.client.batched_stream.send(
                {"op": "pubsub-msg", "name": self.name, "msg": msg,
                 "client": self.client.id}
            )
        else:  # worker-side publisher
            self.client.batched_stream.send(
                {"op": "pubsub-msg", "name": self.name, "msg": msg}
            )


class Sub:
    """Subscribe to a topic (reference pubsub.py:357)."""

    def __init__(self, name: str, client: Any = None):
        self.name = name
        self.client = client
        self.buffer: asyncio.Queue = asyncio.Queue()
        from distributed_tpu_torch.client.client import Client

        if isinstance(client, Client):
            client._pubsub_subs.setdefault(name, []).append(self)
            client.batched_stream.send(
                {"op": "pubsub-add-subscriber", "name": name,
                 "client": client.id}
            )
        else:  # worker-side
            client._pubsub_subs.setdefault(name, []).append(self)
            client.batched_stream.send(
                {"op": "pubsub-add-subscriber", "name": name}
            )

    def _put(self, msg: Any) -> None:
        self.buffer.put_nowait(msg)

    async def get(self, timeout: float | None = None) -> Any:
        return await asyncio.wait_for(self.buffer.get(), timeout)

    def __aiter__(self) -> "Sub":
        return self

    async def __anext__(self) -> Any:
        return await self.get()
