"""Scheduler-hosted coordination extensions.

Equivalents of the reference's cluster-wide primitives, all state held on
the scheduler and accessed over RPC:

- ``EventExtension``    (reference event.py:17)    — named async events
- ``LockExtension``     (reference lock.py:16)     — named mutexes
- ``MultiLockExtension``(reference multi_lock.py:18) — atomic multi-name locks
- ``SemaphoreExtension``(reference semaphore.py:22) — counting semaphores
  with lease timeouts: a crashed client's leases expire and free the slot
- ``QueueExtension``    (reference queues.py:17)   — named FIFO queues
- ``VariableExtension`` (reference variable.py:21) — named mutable cells
- ``PublishExtension``  (reference publish.py:10)  — named datasets kept
  alive by a synthetic client
- ``PubSubSchedulerExtension`` (reference pubsub.py:19) — topic fan-out

Payloads may be plain data or future keys; queues/variables track the keys
they hold via a per-extension synthetic client so the scheduler keeps the
results alive (reference queues.py:101, variable.py:60).

The port's copy of ``distributed_tpu/coordination/extensions.py``, line
for line; the semaphore's lease check is the port's ``PeriodicCallback``.
"""

from __future__ import annotations

import asyncio
import logging
import uuid
from collections import defaultdict, deque
from typing import TYPE_CHECKING, Any

from distributed_tpu_torch.utils.misc import seq_name, time

if TYPE_CHECKING:
    from distributed_tpu_torch.scheduler.server import Scheduler

logger = logging.getLogger("distributed_tpu_torch.coordination")


class EventExtension:
    """Named events (reference event.py:17)."""

    def __init__(self, scheduler: "Scheduler"):
        self.scheduler = scheduler
        self._events: defaultdict[str, asyncio.Event] = defaultdict(asyncio.Event)
        self._waiters: defaultdict[str, int] = defaultdict(int)
        scheduler.handlers.update(
            {
                "event_wait": self.event_wait,
                "event_set": self.event_set,
                "event_clear": self.event_clear,
                "event_is_set": self.event_is_set,
            }
        )

    async def event_wait(self, name: str = "", timeout: float | None = None) -> bool:
        event = self._events[name]
        self._waiters[name] += 1
        try:
            await asyncio.wait_for(event.wait(), timeout)
            return True
        except asyncio.TimeoutError:
            return False
        finally:
            self._waiters[name] -= 1
            self._maybe_forget(name)

    async def event_set(self, name: str = "") -> None:
        self._events[name].set()

    async def event_clear(self, name: str = "") -> None:
        self._events[name].clear()
        self._maybe_forget(name)

    async def event_is_set(self, name: str = "") -> bool:
        return self._events[name].is_set()

    def _maybe_forget(self, name: str) -> None:
        ev = self._events.get(name)
        if ev is not None and not ev.is_set() and not self._waiters[name]:
            self._events.pop(name, None)
            self._waiters.pop(name, None)


class LockExtension:
    """Named mutexes with reentrancy tokens (reference lock.py:16)."""

    def __init__(self, scheduler: "Scheduler"):
        self.scheduler = scheduler
        self.ids: dict[str, str] = {}  # name -> owner id
        self.events: defaultdict[str, asyncio.Event] = defaultdict(asyncio.Event)
        self._waiters: defaultdict[str, int] = defaultdict(int)
        scheduler.handlers.update(
            {
                "lock_acquire": self.acquire,
                "lock_release": self.release,
                "lock_locked": self.locked,
            }
        )

    async def acquire(self, name: str = "", id: str = "",
                      timeout: float | None = None) -> bool:
        deadline = None if timeout is None else time() + timeout
        while name in self.ids:
            if self.ids.get(name) == id:
                return True  # reentrant
            event = self.events[name]
            remaining = None if deadline is None else deadline - time()
            if remaining is not None and remaining <= 0:
                self._maybe_forget(name)
                return False
            self._waiters[name] += 1
            try:
                await asyncio.wait_for(event.wait(), remaining)
            except asyncio.TimeoutError:
                return False
            finally:
                self._waiters[name] -= 1
        self.ids[name] = id
        self.events[name].clear()
        return True

    async def release(self, name: str = "", id: str = "") -> bool:
        if self.ids.get(name) != id:
            raise ValueError(f"lock {name!r} not held by {id!r}")
        del self.ids[name]
        self.events[name].set()
        # fresh event for the next holder cycle
        self.events[name] = asyncio.Event()
        self._maybe_forget(name)
        return True

    def _maybe_forget(self, name: str) -> None:
        """Drop bookkeeping for free, unwaited locks (uuid-named locks
        would otherwise accumulate without bound)."""
        if name not in self.ids and not self._waiters.get(name):
            self.events.pop(name, None)
            self._waiters.pop(name, None)

    async def locked(self, name: str = "") -> bool:
        return name in self.ids


class MultiLockExtension:
    """Atomically acquire several named locks (reference multi_lock.py:18)."""

    def __init__(self, scheduler: "Scheduler"):
        self.scheduler = scheduler
        self.locks: defaultdict[str, list[str]] = defaultdict(list)  # name -> waiter queue
        self.requests: dict[str, set[str]] = {}  # id -> names wanted
        self.requests_left: dict[str, int] = {}  # id -> locks still needed
        self.events: dict[str, asyncio.Event] = {}
        scheduler.handlers.update(
            {
                "multi_lock_acquire": self.acquire,
                "multi_lock_release": self.release,
            }
        )

    async def acquire(self, locks: list[str] = (), id: str = "",
                      timeout: float | None = None, num_locks: int | None = None
                      ) -> bool:
        locks = list(locks)
        num_locks = num_locks if num_locks is not None else len(locks)
        self.requests[id] = set(locks)
        self.events[id] = asyncio.Event()
        acquired_now = 0
        for name in locks:
            queue = self.locks[name]
            queue.append(id)
            if queue[0] == id:
                acquired_now += 1
        self.requests_left[id] = num_locks - acquired_now
        if self.requests_left[id] <= 0:
            self._trim_request(id, locks, num_locks)
            return True
        try:
            await asyncio.wait_for(self.events[id].wait(), timeout)
            self._trim_request(id, locks, num_locks)
            return True
        except asyncio.TimeoutError:
            await self.release(id=id)
            return False
        finally:
            self.events.pop(id, None)

    def _trim_request(self, id: str, locks: list[str], num_locks: int) -> None:
        """Keep only the first num_locks acquired names for this request."""
        if num_locks >= len(locks):
            return
        held = [n for n in locks if self.locks[n] and self.locks[n][0] == id]
        for name in held[num_locks:]:
            self._release_one(name, id)
        self.requests[id] = set(held[:num_locks])

    def _release_one(self, name: str, id: str) -> None:
        queue = self.locks.get(name)
        if not queue or id not in queue:
            return
        was_head = queue[0] == id
        queue.remove(id)
        if not queue:
            del self.locks[name]
            return
        if was_head:
            new_head = queue[0]
            if new_head in self.requests_left:
                self.requests_left[new_head] -= 1
                if self.requests_left[new_head] <= 0:
                    ev = self.events.get(new_head)
                    if ev is not None:
                        ev.set()

    async def release(self, id: str = "") -> None:
        names = self.requests.pop(id, set())
        self.requests_left.pop(id, None)
        for name in list(names):
            self._release_one(name, id)


class SemaphoreExtension:
    """Counting semaphores with expiring leases (reference semaphore.py:22)."""

    LEASE_TIMEOUT = 30.0

    def __init__(self, scheduler: "Scheduler"):
        self.scheduler = scheduler
        self.max_leases: dict[str, int] = {}
        # name -> {lease_id: last_refresh_time}
        self.leases: defaultdict[str, dict[str, float]] = defaultdict(dict)
        self.events: defaultdict[str, asyncio.Event] = defaultdict(asyncio.Event)
        scheduler.handlers.update(
            {
                "semaphore_register": self.create,
                "semaphore_acquire": self.acquire,
                "semaphore_release": self.release,
                "semaphore_refresh_leases": self.refresh_leases,
                "semaphore_value": self.get_value,
                "semaphore_close": self.close_sem,
            }
        )
        from distributed_tpu_torch.rpc.core import PeriodicCallback

        scheduler.periodic_callbacks["semaphore-lease-check"] = PeriodicCallback(
            self._check_lease_timeouts, self.LEASE_TIMEOUT / 3
        )

    async def create(self, name: str = "", max_leases: int = 1) -> None:
        if name not in self.max_leases:
            self.max_leases[name] = max_leases
        elif self.max_leases[name] != max_leases:
            raise ValueError(
                f"semaphore {name!r} exists with max_leases="
                f"{self.max_leases[name]}"
            )

    async def acquire(self, name: str = "", timeout: float | None = None,
                      lease_id: str = "") -> bool:
        deadline = None if timeout is None else time() + timeout
        while len(self.leases[name]) >= self.max_leases.get(name, 1):
            remaining = None if deadline is None else deadline - time()
            if remaining is not None and remaining <= 0:
                return False
            event = self.events[name]
            try:
                await asyncio.wait_for(event.wait(), remaining)
            except asyncio.TimeoutError:
                return False
        self.leases[name][lease_id or uuid.uuid4().hex] = time()
        return True

    async def release(self, name: str = "", lease_id: str = "") -> bool:
        if lease_id in self.leases.get(name, {}):
            del self.leases[name][lease_id]
            self._wake(name)
            return True
        return False

    async def refresh_leases(self, name: str = "",
                             lease_ids: list[str] = ()) -> None:
        now = time()
        for lid in lease_ids:
            if lid in self.leases.get(name, {}):
                self.leases[name][lid] = now

    async def get_value(self, name: str = "") -> int:
        return len(self.leases.get(name, {}))

    async def close_sem(self, name: str = "") -> None:
        self.max_leases.pop(name, None)
        self.leases.pop(name, None)
        self._wake(name)
        self.events.pop(name, None)

    def _wake(self, name: str) -> None:
        ev = self.events.get(name)
        if ev is not None:
            ev.set()
            self.events[name] = asyncio.Event()

    async def _check_lease_timeouts(self) -> None:
        """Expire leases whose holder stopped refreshing (crashed client)."""
        now = time()
        for name, leases in list(self.leases.items()):
            expired = [
                lid for lid, t in leases.items()
                if now - t > self.LEASE_TIMEOUT
            ]
            for lid in expired:
                logger.info("semaphore %r lease %s expired", name, lid[:8])
                del leases[lid]
            if expired:
                self._wake(name)


class QueueExtension:
    """Named FIFO queues holding data or future keys (reference queues.py:17)."""

    def __init__(self, scheduler: "Scheduler"):
        self.scheduler = scheduler
        self.queues: dict[str, asyncio.Queue] = {}
        self.client_refcount: dict[str, int] = {}
        self.client_name = "queue-extension"
        scheduler.handlers.update(
            {
                "queue_create": self.create,
                "queue_put": self.put,
                "queue_get": self.get,
                "queue_qsize": self.qsize,
                "queue_release": self.release,
            }
        )

    async def create(self, name: str = "", maxsize: int = 0) -> None:
        if name not in self.queues:
            self.queues[name] = asyncio.Queue(maxsize=maxsize)
            self.client_refcount[name] = 1
        else:
            self.client_refcount[name] += 1

    async def put(self, name: str = "", value: Any = None, key: str | None = None,
                  timeout: float | None = None) -> None:
        if key is not None:
            record = {"type": "Future", "value": key}
        else:
            record = {"type": "msgpack", "value": value}
        await asyncio.wait_for(self.queues[name].put(record), timeout)
        if key is not None:
            # hold the future alive under this extension's client — only
            # after the put succeeded, or a timeout would leak the key
            self.scheduler.state.client_desires_keys([key], self.client_name)

    async def get(self, name: str = "", timeout: float | None = None,
                  batch: bool = False) -> Any:
        q = self.queues[name]
        if batch:
            out = []
            while not q.empty():
                out.append(q.get_nowait())
            return out
        return await asyncio.wait_for(q.get(), timeout)

    async def qsize(self, name: str = "") -> int:
        return self.queues[name].qsize()

    async def release(self, name: str = "") -> None:
        if name not in self.queues:
            return
        self.client_refcount[name] -= 1
        if self.client_refcount[name] <= 0:
            del self.client_refcount[name]
            q = self.queues.pop(name)
            keys = [
                r["value"] for r in q._queue  # type: ignore[attr-defined]
                if r["type"] == "Future"
            ]
            if keys:
                cm, wm = self.scheduler.state.client_releases_keys(
                    keys, self.client_name, seq_name("queue-release")
                )
                self.scheduler.send_all(cm, wm)


class VariableExtension:
    """Named mutable cells (reference variable.py:21)."""

    def __init__(self, scheduler: "Scheduler"):
        self.scheduler = scheduler
        self.variables: dict[str, dict] = {}
        self.waiting_conditions: defaultdict[str, asyncio.Condition] = defaultdict(
            asyncio.Condition
        )
        self.started = asyncio.Condition()
        self.client_name = "variable-extension"
        scheduler.handlers.update(
            {
                "variable_set": self.set,
                "variable_get": self.get,
                "variable_delete": self.delete,
            }
        )

    async def set(self, name: str = "", value: Any = None,
                  key: str | None = None) -> None:
        if key is not None:
            record = {"type": "Future", "value": key}
            self.scheduler.state.client_desires_keys([key], self.client_name)
        else:
            record = {"type": "msgpack", "value": value}
        old = self.variables.get(name)
        self.variables[name] = record
        if old is not None and old["type"] == "Future" and old["value"] != key:
            cm, wm = self.scheduler.state.client_releases_keys(
                [old["value"]], self.client_name, seq_name("variable-set")
            )
            self.scheduler.send_all(cm, wm)
        async with self.waiting_conditions[name]:
            self.waiting_conditions[name].notify_all()

    async def get(self, name: str = "", timeout: float | None = None) -> dict:
        if name not in self.variables:
            async def _wait():
                async with self.waiting_conditions[name]:
                    await self.waiting_conditions[name].wait_for(
                        lambda: name in self.variables
                    )

            await asyncio.wait_for(_wait(), timeout)
        return self.variables[name]

    async def delete(self, name: str = "") -> None:
        record = self.variables.pop(name, None)
        if record is not None and record["type"] == "Future":
            cm, wm = self.scheduler.state.client_releases_keys(
                [record["value"]], self.client_name, seq_name("variable-del")
            )
            self.scheduler.send_all(cm, wm)
        self.waiting_conditions.pop(name, None)


class PublishExtension:
    """Named published datasets (reference publish.py:10)."""

    def __init__(self, scheduler: "Scheduler"):
        self.scheduler = scheduler
        self.datasets: dict[str, dict] = {}
        self.client_name = "published-datasets"
        scheduler.handlers.update(
            {
                "publish_put": self.put,
                "publish_get": self.get,
                "publish_delete": self.delete,
                "publish_list": self.list,
            }
        )

    async def put(self, name: str = "", keys: list = (), data: Any = None,
                  override: bool = False, client: str | None = None) -> None:
        if name in self.datasets and not override:
            raise KeyError(f"dataset {name!r} already exists")
        self.scheduler.state.client_desires_keys(keys, self.client_name)
        self.datasets[name] = {"data": data, "keys": list(keys)}

    async def get(self, name: str = "") -> dict | None:
        return self.datasets.get(name)

    async def delete(self, name: str = "") -> None:
        out = self.datasets.pop(name, None)
        if out is not None and out["keys"]:
            cm, wm = self.scheduler.state.client_releases_keys(
                out["keys"], self.client_name, seq_name("unpublish")
            )
            self.scheduler.send_all(cm, wm)

    async def list(self) -> list[str]:
        return list(self.datasets)


class PubSubSchedulerExtension:
    """Topic pub/sub relay (reference pubsub.py:19).

    All delivery relays through the scheduler: publishers send
    ``pubsub-msg`` on their batched stream, the extension fans it out to
    every subscribed worker and client except the sender.  (The reference
    additionally short-circuits worker->worker delivery peer-to-peer,
    pubsub.py:120; that optimization can sit on top of this relay without
    protocol changes.)
    """

    def __init__(self, scheduler: "Scheduler"):
        self.scheduler = scheduler
        self.subscribers: defaultdict[str, set[str]] = defaultdict(set)
        self.client_subscribers: defaultdict[str, set[str]] = defaultdict(set)
        scheduler.stream_handlers.update(
            {
                "pubsub-add-subscriber": self.add_subscriber,
                "pubsub-remove-subscriber": self.remove_subscriber,
                "pubsub-msg": self.handle_message,
            }
        )

    def add_subscriber(self, name: str = "", worker: str = "",
                       client: str = "", **kw: Any) -> None:
        if worker:
            self.subscribers[name].add(worker)
        elif client:
            self.client_subscribers[name].add(client)

    def remove_subscriber(self, name: str = "", worker: str = "",
                          client: str = "", **kw: Any) -> None:
        if worker:
            self.subscribers[name].discard(worker)
        elif client:
            self.client_subscribers[name].discard(client)

    def handle_message(self, name: str = "", msg: Any = None,
                       worker: str = "", client: str = "", **kw: Any) -> None:
        # relay to subscribed clients (except the sender)
        for c in list(self.client_subscribers[name]):
            if c != client:
                self.scheduler.report(
                    {"op": "pubsub-msg", "name": name, "msg": msg}, client=c
                )
        # relay to subscribed workers (except the sender)
        for addr in self.subscribers[name]:
            if addr != worker:
                self.scheduler.send_all({}, {addr: [{
                    "op": "pubsub-msg", "name": name, "msg": msg,
                }]})


def coordination_extensions() -> dict[str, Any]:
    return {
        "events": EventExtension,
        "locks": LockExtension,
        "multi_locks": MultiLockExtension,
        "semaphores": SemaphoreExtension,
        "queues": QueueExtension,
        "variables": VariableExtension,
        "publish": PublishExtension,
        "pubsub": PubSubSchedulerExtension,
    }
