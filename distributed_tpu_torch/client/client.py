"""Client: futures, submit/map/gather/scatter (reference client.py).

The client keeps one batched stream to the scheduler; ``_handle_report``
dispatches ``key-in-memory`` / ``task-erred`` / ``lost-data`` report
messages onto client-side ``Future`` objects, which are refcounted so the
scheduler can release results nobody holds anymore
(reference client.py:174,741,1548).

Async-first: every API is a coroutine on the running event loop; the
sync facade (``Client(..., asynchronous=False)``) drives a dedicated
loop thread via ``LoopRunner`` like the reference's ``SyncMethodMixin``.

The port's copy of ``distributed_tpu/client/client.py``, line for line.
Task functions travel by the standard library's pickle (the port has no
cloudpickle): they must be importable module-level functions.
"""

from __future__ import annotations

import asyncio
import logging
import os
import uuid
from collections.abc import Iterable, Iterator
from typing import Any, Callable

from distributed_tpu_torch import config
from distributed_tpu_torch.comm.core import Comm, connect
from distributed_tpu_torch.exceptions import CommClosedError
from distributed_tpu_torch.graph.spec import Graph, Key, TaskRef, TaskSpec, tokenize
from distributed_tpu_torch.protocol.serialize import Serialize, unwrap
from distributed_tpu_torch.rpc.batched import BatchedSend
from distributed_tpu_torch.rpc.core import raise_remote_error, rpc
from distributed_tpu_torch.utils.misc import LoopRunner, funcname, seq_name, time

logger = logging.getLogger("distributed_tpu_torch.client")


class FutureState:
    """Client-side record of one key's lifecycle."""

    __slots__ = ("event", "status", "type", "exception", "traceback", "traceback_text")

    def __init__(self) -> None:
        self.event = asyncio.Event()
        self.status = "pending"
        self.type: str | None = None
        self.exception: BaseException | None = None
        self.traceback: Any = None
        self.traceback_text = ""

    def finish(self, type: str | None = None) -> None:
        self.status = "finished"
        self.type = type
        self.event.set()

    def lose(self) -> None:
        self.status = "lost"
        self.event.clear()

    def set_error(self, exception: BaseException, traceback: Any,
                  traceback_text: str = "") -> None:
        self.status = "error"
        self.exception = exception
        self.traceback = traceback
        self.traceback_text = traceback_text
        self.event.set()

    def cancel(self) -> None:
        self.status = "cancelled"
        self.exception = asyncio.CancelledError()
        self.event.set()

    def retry(self) -> None:
        """Scheduler reran an erred/lost key: wait for the new attempt."""
        self.status = "pending"
        self.exception = None
        self.traceback = None
        self.traceback_text = ""
        self.event.clear()


class Future:
    """A remote result (reference client.py:174)."""

    def __init__(self, key: Key, client: "Client"):
        self.key = key
        self.client = client
        self._cleared = False
        client._inc_ref(key)

    @property
    def _state(self) -> FutureState:
        return self.client.futures[self.key]

    @property
    def status(self) -> str:
        if self.client is None:
            return "unbound"
        st = self.client.futures.get(self.key)
        return st.status if st is not None else "cancelled"

    def done(self) -> bool:
        if self.client is None:
            return False
        st = self.client.futures.get(self.key)
        return st is not None and st.event.is_set()

    def cancelled(self) -> bool:
        return self.status == "cancelled"

    async def result(self, timeout: float | None = None):
        """Wait for and fetch the value (async; the sync shell wraps this)."""
        return await self.client._result(self, timeout=timeout)

    async def exception(self, timeout: float | None = None):
        st = self.client.futures.get(self.key)
        if st is None:
            return None
        await asyncio.wait_for(st.event.wait(), timeout)
        return st.exception

    async def traceback(self, timeout: float | None = None):
        st = self.client.futures.get(self.key)
        if st is None:
            return None
        await asyncio.wait_for(st.event.wait(), timeout)
        return st.traceback

    async def cancel(self):
        await self.client.cancel([self])

    def release(self) -> None:
        if not self._cleared:
            self._cleared = True
            self.client._dec_ref(self.key)

    def __del__(self):
        try:
            self.release()
        except Exception:
            pass

    def __repr__(self) -> str:
        return f"<Future: {self.status}, key: {self.key}>"

    def _repr_html_(self) -> str:
        color = {
            "finished": "green", "error": "red", "cancelled": "gray"
        }.get(self.status, "orange")
        return (
            f"<b>Future:</b> <tt>{self.key}</tt> "
            f"<b style='color:{color}'>{self.status}</b>"
        )

    def __getstate__(self) -> str:
        # futures pickle as their key alone (reference client.py:430);
        # the receiving side rebinds to its own client (_rebind_futures)
        return self.key

    def __setstate__(self, key: str) -> None:
        self.key = key
        self.client = None  # unbound stub until rebound
        self._cleared = True

    def __await__(self):
        return self.result().__await__()

    def __hash__(self) -> int:
        return hash(self.key)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Future) and other.key == self.key


class Client:
    """Entry point for users (reference client.py:741)."""

    def __init__(
        self,
        address: str | None = None,
        *,
        asynchronous: bool = True,
        name: str | None = None,
        timeout: float = 10.0,
        heartbeat_interval: float | None = None,
        security: Any | None = None,
    ):
        self.address = address
        self.security = security
        self._connection_args = (
            security.get_connection_args("client") if security is not None
            else {}
        )
        self.id = f"Client-{name or ''}{uuid.uuid4().hex[:12]}"
        self._heartbeat_interval = heartbeat_interval
        self._heartbeat_pc: Any | None = None
        self.futures: dict[Key, FutureState] = {}
        # pickled-size cache for the large-closure warning: weak keys so
        # user functions die normally and ids are never reused stale
        import weakref

        self._fn_sizes: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self.refcount: dict[Key, int] = {}
        self._cancel_expected: dict[Key, "FutureState"] = {}
        self.scheduler_comm: Comm | None = None
        self.batched_stream = BatchedSend()
        self.scheduler: rpc | None = None
        self.status = "newly-created"
        self.asynchronous = asynchronous
        self._timeout = timeout
        self._handle_report_task: asyncio.Task | None = None
        self._pubsub_subs: dict[str, list] = {}
        self._event_handlers: dict[str, list] = {}
        self._worker_rpcs: dict[str, Any] = {}
        self._scheduler_identity: dict = {}  # last identity() snapshot
        self._generation = 0
        self.loop: asyncio.AbstractEventLoop | None = None
        self._loop_runner: LoopRunner | None = None
        if not asynchronous:
            self._loop_runner = LoopRunner()
            self._loop_runner.start()
            self.sync(self._start)

    # ------------------------------------------------------- sync facade

    def gather_sync(self, futures: Any, errors: str = "raise") -> Any:
        return self.sync(self.gather, futures, errors=errors)

    def result_sync(self, future: "Future", timeout: float | None = None) -> Any:
        return self.sync(future.result, timeout=timeout)

    def scatter_sync(self, data: Any, **kwargs: Any) -> Any:
        return self.sync(self.scatter, data, **kwargs)

    # ------------------------------------------------------------ lifecycle

    def sync(self, coro_fn: Callable, *args: Any, **kwargs: Any) -> Any:
        assert self._loop_runner is not None
        return self._loop_runner.run_sync(coro_fn, *args, **kwargs)

    async def _start(self) -> "Client":
        self.loop = asyncio.get_running_loop()
        comm = await connect(self.address, **self._connection_args)
        await comm.write(
            {"op": "register-client", "client": self.id, "reply": False}
        )
        resp = await comm.read()
        if resp.get("status") != "OK":
            raise ValueError(f"scheduler rejected client: {resp!r}")
        self.scheduler_comm = comm
        self.batched_stream.start(comm)
        self.scheduler = rpc(
            self.address, connection_args=self._connection_args
        )
        self._handle_report_task = asyncio.create_task(self._handle_report())
        # liveness heartbeat on the batched stream (reference
        # client.heartbeat 5s): the scheduler stamps ClientState.last_seen
        interval = (
            self._heartbeat_interval
            if self._heartbeat_interval is not None
            else config.parse_timedelta(config.get("client.heartbeat", "5s"))
        )
        if interval and interval > 0:
            from distributed_tpu_torch.rpc.core import PeriodicCallback

            def _beat() -> None:
                try:
                    self.batched_stream.send(
                        {"op": "heartbeat-client", "client": self.id}
                    )
                except Exception:
                    pass

            self._heartbeat_pc = PeriodicCallback(_beat, interval)
            self._heartbeat_pc.start()
        self.status = "running"
        try:
            # one identity snapshot at connect so _repr_html_ (sync, must
            # not block) has workers/dashboard to show immediately
            await self.scheduler_info()
        except Exception:  # pragma: no cover - scheduler racing shutdown
            pass
        logger.info("%s connected to %s", self.id, self.address)
        return self

    async def __aenter__(self) -> "Client":
        if self.status == "newly-created":
            await self._start()
        return self

    async def __aexit__(self, *exc: Any) -> None:
        await self.close()

    def __enter__(self) -> "Client":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.sync(self.close)
        if self._loop_runner is not None:
            self._loop_runner.stop()

    async def close(self) -> None:
        if self.status == "closed":
            return
        self.status = "closed"
        if self._heartbeat_pc is not None:
            self._heartbeat_pc.stop()
        if self._handle_report_task is not None:
            self._handle_report_task.cancel()
            try:
                await self._handle_report_task
            except (asyncio.CancelledError, Exception):
                pass
        try:
            if not self.batched_stream.closed():
                self.batched_stream.send({"op": "close-client", "client": self.id})
                self.batched_stream.send({"op": "close-stream"})
        except CommClosedError:
            pass
        await self.batched_stream.close(timeout=1)
        if self.scheduler_comm is not None:
            await self.scheduler_comm.close()
        if self.scheduler is not None:
            await self.scheduler.close_rpc()
        for r in self._worker_rpcs.values():
            await r.close_rpc()
        self._worker_rpcs.clear()
        for st in self.futures.values():
            if not st.event.is_set():
                st.cancel()

    # ------------------------------------------------------- report stream

    async def _handle_report(self) -> None:
        """Dispatch scheduler report messages (reference client.py:1548)."""
        assert self.scheduler_comm is not None
        try:
            while True:
                msgs = await self.scheduler_comm.read()
                if not isinstance(msgs, (list, tuple)):
                    msgs = (msgs,)
                for msg in msgs:
                    if msg == "OK":
                        continue
                    op = msg.pop("op", None)
                    if op == "key-in-memory":
                        self._handle_key_in_memory(**msg)
                    elif op == "task-erred":
                        self._handle_task_erred(**msg)
                    elif op == "lost-data":
                        self._handle_lost_data(**msg)
                    elif op == "cancelled-keys":
                        for key in msg.get("keys", ()):
                            # the state was already cancelled synchronously
                            # in Client.cancel; this report arrives over
                            # the batched stream and may postdate a
                            # RESUBMISSION of the key — only apply it to
                            # the FutureState the cancel targeted
                            missing = object()
                            expected = self._cancel_expected.pop(key, missing)
                            st = self.futures.get(key)
                            if st is not None and (
                                expected is missing or st is expected
                            ):
                                st.cancel()
                    elif op == "task-retried":
                        # another client's retry reran this key: drop our
                        # terminal view and wait for the fresh attempt.
                        # The initiating client reset its state in
                        # retry() already; anything non-terminal (e.g. a
                        # resubmission racing this report) is left alone
                        st = self.futures.get(msg.get("key"))
                        if st is not None and st.status in ("error", "lost"):
                            st.retry()
                    elif op == "pubsub-msg":
                        for sub in self._pubsub_subs.get(msg.get("name"), ()):
                            sub._put(msg.get("msg"))
                    elif op == "event":
                        for handler in self._event_handlers.get(
                            msg.get("topic"), ()
                        ):
                            try:
                                handler(msg.get("msg"))
                            except Exception:
                                logger.exception("event handler failed")
                    elif op in ("stream-closed", "close", "restart"):
                        if op == "restart":
                            # the initiating client cancels its futures
                            # in restart() itself; its tagged echo must
                            # not cancel work submitted since (the
                            # report stream is unordered with the rpc).
                            # Other clients cancel exactly the keys the
                            # scheduler snapshotted as theirs AT restart
                            # time — futures whose submission the
                            # scheduler processed after the restart are
                            # alive and must survive the echo.
                            if msg.get("initiator") != self.id:
                                keys = msg.get("keys")
                                if keys is None:
                                    targets = list(self.futures.values())
                                else:
                                    targets = [
                                        st for k in keys
                                        if (st := self.futures.get(k))
                                        is not None
                                    ]
                                for st in targets:
                                    st.cancel()
                        if op != "restart":
                            return
        except (CommClosedError, asyncio.CancelledError):
            pass
        finally:
            if self.status == "running":
                self.status = "connection-lost"
                for st in self.futures.values():
                    if not st.event.is_set():
                        st.set_error(
                            CommClosedError("lost connection to scheduler"), None
                        )

    def _handle_key_in_memory(self, key: Key = "", type: str | None = None,
                              **kw: Any) -> None:
        st = self.futures.get(key)
        if st is not None:
            st.finish(type=type)

    def _handle_task_erred(self, key: Key = "", exception: Any = None,
                           traceback: Any = None, **kw: Any) -> None:
        st = self.futures.get(key)
        if st is not None:
            exc = unwrap(exception)
            if not isinstance(exc, BaseException):
                exc = Exception(str(exc))
            st.set_error(exc, unwrap(traceback), kw.get("traceback_text", ""))

    def _handle_lost_data(self, key: Key = "", **kw: Any) -> None:
        st = self.futures.get(key)
        if st is not None:
            st.lose()

    # ---------------------------------------------------------- refcounting

    def _inc_ref(self, key: Key) -> None:
        self.refcount[key] = self.refcount.get(key, 0) + 1

    def _dec_ref(self, key: Key) -> None:
        n = self.refcount.get(key, 0) - 1
        if n <= 0:
            self.refcount.pop(key, None)
            self.futures.pop(key, None)
            # a pending cancel-confirmation for a dead key will never
            # matter again; don't let the sentinel (and its FutureState)
            # outlive the futures entry
            self._cancel_expected.pop(key, None)
            if self.status == "running" and not self.batched_stream.closed():
                try:
                    self.batched_stream.send(
                        {
                            "op": "client-releases-keys",
                            "keys": [key],
                            "client": self.id,
                        }
                    )
                except CommClosedError:
                    pass
        else:
            self.refcount[key] = n

    # ------------------------------------------------------------ submission

    def _warn_large_function(self, fn: Callable) -> None:
        """Task specs are serialized independently (one opaque leaf per
        task — the scheduler never unpickles them), so a large captured
        closure is pickled once PER TASK, not once per graph.  Warn like
        the reference (client.py 'Large object of size ... detected')
        and point at scatter, which exists for exactly this."""
        try:
            nbytes = self._fn_sizes.get(fn)
        except TypeError:
            return  # unhashable/unweakrefable callable: skip the check
        if nbytes is None:
            try:
                from distributed_tpu_torch.protocol.pickle import dumps

                nbytes = len(dumps(fn))
                self._fn_sizes[fn] = nbytes
            except Exception:
                return
        else:
            return  # measured before: already warned if it was large
        threshold = config.parse_bytes(
            config.get("admin.large-function-warning-bytes")
        )
        if threshold and nbytes > threshold:
            logger.warning(
                "Large function payload (%.1f MiB) detected in map(): it is "
                "serialized once per task. Move captured data into "
                "arguments via client.scatter() and pass the future instead.",
                nbytes / 2**20,
            )

    def _graph_to_futures(
        self,
        tasks: dict[Key, Any],
        keys: list[Key],
        *,
        priority: int = 0,
        workers: list[str] | str | None = None,
        allow_other_workers: bool = False,
        resources: dict | None = None,
        retries: int | None = None,
        actors: Any = False,
        annotations_by_key: dict[Key, dict] | None = None,
    ) -> dict[Key, Future]:
        """Ship a graph, returning futures for ``keys``
        (reference client.py:3098)."""
        deps = {
            k: sorted(spec.dependencies()) if isinstance(spec, TaskSpec) else []
            for k, spec in tasks.items()
        }
        annotations: dict[Key, dict] = dict(annotations_by_key or {})
        ann: dict[str, Any] = {}
        from distributed_tpu_torch.diagnostics.spans import current_span

        active_span = current_span()
        if active_span:
            ann["span"] = list(active_span)
        if workers is not None:
            ann["workers"] = workers
            if allow_other_workers:
                ann["allow_other_workers"] = True
        if resources:
            ann["resources"] = resources
        if retries:
            ann["retries"] = retries
        if ann:
            annotations = {k: {**ann, **annotations.get(k, {})} for k in tasks}
        futures: dict[Key, Future] = {}
        for key in keys:
            if key not in self.futures:
                self.futures[key] = FutureState()
            futures[key] = Future(key, self)
        self._generation += 1
        self.batched_stream.send(
            {
                "op": "update-graph",
                "client": self.id,
                # one Serialize leaf PER TASK, not one blob: the scheduler
                # (deserialize=False) stores each run_spec as opaque frames
                # and forwards them to workers verbatim — user code is
                # unpickled only where it runs
                "tasks": {k: Serialize(v) for k, v in tasks.items()},
                "dependencies": deps,
                "keys": list(keys),
                "user_priority": priority,
                "annotations_by_key": annotations or None,
                "actors": actors,
                "stimulus_id": seq_name("update-graph"),
            }
        )
        return futures

    def submit(
        self,
        fn: Callable,
        *args: Any,
        key: Key | None = None,
        pure: bool = True,
        priority: int = 0,
        workers: list[str] | str | None = None,
        allow_other_workers: bool = False,
        resources: dict | None = None,
        retries: int | None = None,
        actor: bool = False,
        **kwargs: Any,
    ) -> Future:
        """Run ``fn(*args, **kwargs)`` on the cluster (reference client.py:1828)."""
        if key is None:
            if pure and not actor:
                key = f"{funcname(fn)}-{tokenize(fn, args, tuple(sorted(kwargs.items())))}"
            else:
                key = f"{funcname(fn)}-{uuid.uuid4().hex[:16]}"
        st = self.futures.get(key)
        if st is not None:
            if st.status != "cancelled":
                return Future(key, self)
            # resubmission of a cancelled key: replace the stale client
            # state so a fresh task goes to the scheduler — but KEEP the
            # refcount: old cancelled Future objects still reference the
            # key, and their later release must not free the new task
            del self.futures[key]
        spec_args = _futures_to_refs(args)
        spec_kwargs = _futures_to_refs(kwargs)
        tasks: dict[Key, Any] = {key: TaskSpec(fn, spec_args, spec_kwargs)}
        futs = self._graph_to_futures(
            tasks, [key], priority=priority, workers=workers,
            allow_other_workers=allow_other_workers, resources=resources,
            retries=retries, actors=[key] if actor else False,
        )
        return futs[key]

    def map(
        self,
        fn: Callable,
        *iterables: Iterable,
        key: str | None = None,
        pure: bool = True,
        priority: int = 0,
        workers: list[str] | str | None = None,
        allow_other_workers: bool = False,
        resources: dict | None = None,
        retries: int | None = None,
        **kwargs: Any,
    ) -> list[Future]:
        """Map a function over argument lists (reference client.py:1967)."""
        iterables = tuple(list(it) for it in iterables)
        prefix = key or funcname(fn)
        self._warn_large_function(fn)
        tasks: dict[Key, Any] = {}
        keys: list[Key] = []
        for i, zargs in enumerate(zip(*iterables)):
            if pure:
                k = f"{prefix}-{tokenize(fn, zargs, tuple(sorted(kwargs.items())))}"
            else:
                k = f"{prefix}-{uuid.uuid4().hex[:16]}"
            keys.append(k)
            if k in tasks:
                continue
            st = self.futures.get(k)
            if st is not None:
                if st.status != "cancelled":
                    continue
                # same cancelled-key resubmission contract as submit()
                del self.futures[k]
            tasks[k] = TaskSpec(fn, _futures_to_refs(zargs), _futures_to_refs(kwargs))
        futs = self._graph_to_futures(
            {k: v for k, v in tasks.items()},
            [k for k in dict.fromkeys(keys)],
            priority=priority, workers=workers,
            allow_other_workers=allow_other_workers, resources=resources,
            retries=retries,
        )
        return [futs.get(k) or Future(k, self) for k in keys]

    def compute_graph(self, graph: Graph, keys: list[Key], **kwargs: Any
                      ) -> dict[Key, Future]:
        """Submit a pre-built ``Graph`` (the collections entry point)."""
        graph.validate()
        return self._graph_to_futures(dict(graph.tasks), keys, **kwargs)

    # ------------------------------------------------------------- results

    async def _result(self, future: Future, timeout: float | None = None) -> Any:
        st = self.futures.get(future.key)
        if st is None:
            raise asyncio.CancelledError(future.key)
        # one deadline for the WHOLE wait: re-waits after a task-retried
        # reset must not re-arm the user's timeout
        loop = asyncio.get_running_loop()
        deadline = None if timeout is None else loop.time() + timeout
        remaining = (
            (lambda: None) if deadline is None
            else (lambda: max(deadline - loop.time(), 0.001))
        )
        await asyncio.wait_for(st.event.wait(), remaining())
        while st.status == "pending":
            # woken by a terminal state that a task-retried report then
            # reset before this coroutine resumed: the key is being
            # recomputed — wait for the NEW attempt, don't gather it
            await asyncio.wait_for(st.event.wait(), remaining())
        if st.status == "error":
            assert st.exception is not None
            raise st.exception
        if st.status == "cancelled":
            raise asyncio.CancelledError(future.key)
        data = await self._gather_keys([future.key])
        return self._maybe_actor(data[future.key])

    def _maybe_actor(self, value: Any) -> Any:
        from distributed_tpu_torch.client.actor import Actor, ActorPlaceholder

        if isinstance(value, ActorPlaceholder):
            return Actor.from_placeholder(value, io=self._worker_rpc(value.worker))
        return value

    def _worker_rpc(self, address: str):
        """Cached direct rpc to a worker (actor calls, direct gather)."""
        r = self._worker_rpcs.get(address)
        if r is None:
            from distributed_tpu_torch.rpc.core import rpc as _rpc

            r = self._worker_rpcs[address] = _rpc(
                address, connection_args=self._connection_args
            )
        return r

    async def gather(self, futures: Any, errors: str = "raise") -> Any:
        """Wait for and download many futures (reference client.py:2317);
        preserves the nesting structure of ``futures``."""
        flat: list[Future] = []
        _collect_futures(futures, flat)
        # wait for completion
        for f in flat:
            st = self.futures.get(f.key)
            if st is None:
                if errors == "skip":
                    continue
                raise asyncio.CancelledError(f.key)
            await st.event.wait()
            while st.status == "pending":
                # set_error raced a task-retried reset (see _result):
                # re-wait for the new attempt's completion
                await st.event.wait()
            if st.status == "error" and errors == "raise":
                assert st.exception is not None
                raise st.exception
            if st.status == "cancelled" and errors == "raise":
                raise asyncio.CancelledError(f.key)
        keys = [
            f.key
            for f in flat
            if (st := self.futures.get(f.key)) is not None
            and st.status == "finished"
        ]
        data = await self._gather_keys(list(dict.fromkeys(keys)))
        return _substitute_futures(futures, data, errors)

    def _ensure_tracked(self, key: Key) -> "FutureState":
        """Track a key learned out-of-band (queue/variable/dataset): register
        interest with the scheduler, which reports its current state."""
        st = self.futures.get(key)
        if st is None:
            st = self.futures[key] = FutureState()
            self.batched_stream.send(
                {"op": "client-desires-keys", "keys": [key], "client": self.id}
            )
        return st

    async def _gather_keys(self, keys: list[Key]) -> dict[Key, Any]:
        if not keys:
            return {}
        assert self.scheduler is not None
        attempts = 3
        for attempt in range(attempts):
            resp = await self.scheduler.gather(keys=keys)
            if resp.get("status") == "OK":
                return {
                    k: self._maybe_actor(unwrap(v))
                    for k, v in resp["data"].items()
                }
            missing = resp.get("keys", [])
            logger.warning("gather attempt %d missing %s", attempt, missing)
            await asyncio.sleep(0.1 * (attempt + 1))
        raise KeyError(f"could not gather keys: {missing}")

    async def scatter(
        self,
        data: Any,
        workers: list[str] | None = None,
        broadcast: bool = False,
        hash: bool = True,
    ) -> Any:
        """Push local data into cluster memory (reference client.py:2486)."""
        unpack_single = False
        if isinstance(data, dict):
            named = {str(k): v for k, v in data.items()}
        else:
            if not isinstance(data, (list, tuple, set)):
                data = [data]
                unpack_single = True
            named = {}
            for v in data:
                if hash:
                    k = f"{type(v).__name__}-{tokenize_data(v)}"
                else:
                    k = f"{type(v).__name__}-{uuid.uuid4().hex[:16]}"
                named[k] = v
        assert self.scheduler is not None
        for key in named:
            if key not in self.futures:
                self.futures[key] = FutureState()
        keys = await self.scheduler.scatter(
            data={k: Serialize(v) for k, v in named.items()},
            client=self.id,
            workers=workers,
            broadcast=broadcast,
        )
        futs = {}
        for k in keys:
            self.futures[k].finish()
            futs[k] = Future(k, self)
        if isinstance(data, dict):
            return futs
        out = [futs[k] for k in named if k in futs]
        return out[0] if unpack_single else out

    async def cancel(self, futures: Iterable[Future], force: bool = False) -> None:
        keys = [f.key for f in futures]
        # cancel synchronously client-side (reference client.py _cancel):
        # the scheduler's confirmation rides the batched stream and could
        # otherwise cancel a future resubmitted in the meantime.  A key
        # with no state still registers (None) so the confirmation can
        # never hit a later resubmission.
        for k in keys:
            st = self.futures.get(k)
            if st is not None:
                st.cancel()
            self._cancel_expected[k] = st
        assert self.scheduler is not None
        await self.scheduler.cancel(keys=keys, client=self.id, force=force)

    async def retry(self, futures: Iterable[Future]) -> None:
        keys = []
        for f in futures:
            st = self.futures.get(f.key)
            if st is not None:
                st.retry()
            keys.append(f.key)
        assert self.scheduler is not None
        await self.scheduler.retry(keys=keys, client=self.id)

    # ------------------------------------------------------------ cluster ops

    async def run(self, fn: Callable, *args: Any,
                  workers: list[str] | None = None, wait: bool = True,
                  nanny: bool = False, **kwargs: Any) -> dict:
        """Run a function on workers (or their nannies with nanny=True)
        outside the task system (reference client.py:2904)."""
        assert self.scheduler is not None
        resp = await self.scheduler.broadcast(
            msg={
                "op": "run",
                "function": Serialize(fn),
                "args": Serialize(args),
                "kwargs": Serialize(kwargs),
                "wait": wait,
            },
            workers=workers,
            nanny=nanny,
        )
        out = {}
        for addr, r in resp.items():
            if isinstance(r, dict) and r.get("status") == "error":
                raise_remote_error(r)
            out[addr] = unwrap(r.get("result")) if isinstance(r, dict) else r
        return out

    async def run_on_scheduler(self, fn: Callable, *args: Any, **kwargs: Any) -> Any:
        assert self.scheduler is not None
        resp = await self.scheduler.run_function(
            function=Serialize(fn), args=Serialize(args), kwargs=Serialize(kwargs)
        )
        if resp.get("status") == "error":
            raise_remote_error(resp)
        return unwrap(resp.get("result"))

    async def restart(self) -> None:
        """Forget every task cluster-wide; cancel this client's futures.

        The report stream is unordered with the rpc reply, so the echo
        is initiator-tagged and skipped here (a counter would leak on
        rpc failure).  Futures cancel in a finally: restart's intent is
        cancel-everything, and on an rpc failure the scheduler may or
        may not have restarted — pending futures must not hang either
        way."""
        assert self.scheduler is not None
        try:
            await self.scheduler.restart(client=self.id)
        finally:
            for st in self.futures.values():
                st.cancel()

    async def rebalance(self, futures: Iterable[Future] | None = None,
                        workers: list[str] | None = None) -> dict:
        """Even data across workers (reference client.py:3824)."""
        assert self.scheduler is not None
        keys = [f.key for f in futures] if futures is not None else None
        return await self.scheduler.rebalance(keys=keys, workers=workers)

    async def replicate(self, futures: Iterable[Future], n: int | None = None,
                        workers: list[str] | None = None) -> None:
        """Copy futures' data onto additional workers
        (reference client.py:3732)."""
        assert self.scheduler is not None
        await self.scheduler.replicate(
            keys=[f.key for f in futures], n=n, workers=workers
        )

    async def register_plugin(self, plugin: Any, name: str | None = None,
                              nanny: bool | None = None) -> Any:
        """Install a Scheduler/Worker/Nanny plugin cluster-wide
        (reference client.py register_plugin).

        ``nanny`` overrides the isinstance routing (reference has the
        same parameter): a NannyPlugin like ``UploadDirectory`` on a
        nanny-LESS cluster would otherwise broadcast to zero nannies and
        silently ship nothing — pass ``nanny=False`` to run its setup on
        the workers instead."""
        from distributed_tpu_torch.diagnostics.plugin import (
            NannyPlugin,
            SchedulerPlugin,
        )

        assert self.scheduler is not None
        name = name or getattr(plugin, "name", None)
        if isinstance(plugin, SchedulerPlugin):
            return await self.scheduler.register_scheduler_plugin(
                plugin=Serialize(plugin), name=name
            )
        if nanny if nanny is not None else isinstance(plugin, NannyPlugin):
            resp = await self.scheduler.register_nanny_plugin(
                plugin=Serialize(plugin), name=name
            )
        else:
            # default: worker plugin (reference treats unknown as one)
            resp = await self.scheduler.register_worker_plugin(
                plugin=Serialize(plugin), name=name
            )
        # a failing setup() must not pass silently: the broadcast result
        # carries per-node error_message dicts (reference re-raises too)
        if isinstance(resp, dict):
            for r in resp.values():
                if isinstance(r, dict) and r.get("status") == "error":
                    from distributed_tpu_torch.rpc.core import raise_remote_error

                    raise_remote_error(r)
        return resp

    async def unregister_worker_plugin(self, name: str) -> Any:
        assert self.scheduler is not None
        return await self.scheduler.unregister_worker_plugin(name=name)

    async def upload_file(self, path: str) -> None:
        """Ship a source file to all current and future workers
        (reference client.py:3767)."""
        from distributed_tpu_torch.diagnostics.plugin import UploadFile

        await self.register_plugin(
            UploadFile(path), name=f"upload-{os.path.basename(path)}"
        )

    async def dump_cluster_state(self, filename: str | None = None) -> dict:
        """Full-state debug dump (reference client.py dump_cluster_state,
        cluster_dump.py)."""
        assert self.scheduler is not None
        state = await self.scheduler.get_cluster_state()
        if filename:
            import json

            def _write() -> None:  # dump can be huge: keep it off-loop
                with open(filename, "w") as f:
                    json.dump(state, f, default=str, indent=1)

            await asyncio.get_running_loop().run_in_executor(None, _write)
        return state

    async def memory_trace_start(self, workers: list[str] | None = None) -> dict:
        """Begin allocation tracing on workers (reference memray.py role;
        stdlib tracemalloc — no extra dependency)."""
        assert self.scheduler is not None
        return await self.scheduler.broadcast(
            msg={"op": "memory_trace", "action": "start"}, workers=workers
        )

    async def memory_trace_stop(self, workers: list[str] | None = None) -> dict:
        assert self.scheduler is not None
        return await self.scheduler.broadcast(
            msg={"op": "memory_trace", "action": "stop"}, workers=workers
        )

    async def memory_trace_report(self, top_n: int = 10,
                                  workers: list[str] | None = None) -> dict:
        """Per-worker top allocation sites + data-store view, so leaked
        interpreter memory is distinguishable from stored results."""
        assert self.scheduler is not None
        from distributed_tpu_torch.protocol.serialize import nested_deserialize

        return nested_deserialize(await self.scheduler.broadcast(
            msg={"op": "memory_trace", "action": "report", "top_n": top_n},
            workers=workers,
        ))

    async def device_profile_start(
        self, workers: list[str] | None = None,
        logdir: str | None = None,
    ) -> dict:
        """Begin an XLA device-timeline trace on workers (the
        reference's low-level profiler role, profile.py:550 — see
        diagnostics/device_profile.py).  Tasks executed while tracing
        carry their key as a device-timeline annotation."""
        assert self.scheduler is not None
        return await self.scheduler.broadcast(
            msg={"op": "device_profile", "action": "start",
                 "logdir": logdir},
            workers=workers,
        )

    async def device_profile_stop(
        self, workers: list[str] | None = None
    ) -> dict:
        """End the device trace; each worker reports its trace directory
        (TensorBoard/XProf ``plugins/profile`` format) and the files
        captured."""
        assert self.scheduler is not None
        return await self.scheduler.broadcast(
            msg={"op": "device_profile", "action": "stop"},
            workers=workers,
        )

    async def recreate_error_locally(self, future: Future) -> None:
        """Re-run a failed task in this process for debugging
        (reference recreate_tasks.py:15)."""
        st = self.futures.get(future.key)
        if st is None:
            raise ValueError(f"unknown future {future.key}")
        await st.event.wait()
        if st.status != "error":
            raise ValueError(f"future {future.key} did not err")
        assert self.scheduler is not None
        resp = await self.scheduler.get_runspec(key=future.key)
        spec = unwrap(resp["run_spec"])
        deps = await self._gather_keys(resp["deps"])
        fn, args, kwargs = spec.substitute(deps)
        # raises the task's error in the caller's process
        if asyncio.iscoroutinefunction(fn):
            await fn(*args, **kwargs)
        else:
            fn(*args, **kwargs)

    # ------------------------------------------------------- observability

    def log_event(self, topic: str, msg: Any) -> None:
        """Record a structured event on the scheduler (reference
        client.py log_event)."""
        self.batched_stream.send(
            {"op": "log-event-client", "topic": topic, "msg": msg,
             "client": self.id}
        )

    async def get_events(self, topic: str | None = None) -> Any:
        assert self.scheduler is not None
        return await self.scheduler.events(topic=topic)

    def subscribe_topic(self, topic: str, handler: Callable) -> None:
        """Call ``handler(msg)`` for every event on ``topic``
        (reference client.py:4503)."""
        self._event_handlers.setdefault(topic, []).append(handler)
        self.batched_stream.send(
            {"op": "subscribe-topic", "topic": topic, "client": self.id}
        )

    def unsubscribe_topic(self, topic: str) -> None:
        self._event_handlers.pop(topic, None)
        self.batched_stream.send(
            {"op": "unsubscribe-topic", "topic": topic, "client": self.id}
        )

    async def get_task_stream(self, start: float | None = None,
                              count: int | None = None) -> list:
        assert self.scheduler is not None
        return await self.scheduler.get_task_stream(start=start, count=count)

    async def get_spans(self) -> list:
        assert self.scheduler is not None
        return await self.scheduler.get_spans()

    async def get_versions(self, check: bool = False) -> dict:
        """Version info for scheduler, workers, and this client
        (reference client.py get_versions)."""
        from distributed_tpu_torch.versions import get_versions, version_mismatches

        assert self.scheduler is not None
        out = {
            "client": get_versions(),
            "scheduler": await self.scheduler.versions(),
            "workers": await self.scheduler.worker_versions(),
        }
        mismatches = version_mismatches(out)
        if mismatches and check:
            raise ValueError(f"version mismatches: {mismatches}")
        out["mismatches"] = mismatches
        return out

    async def benchmark_hardware(self) -> dict:
        """Memory/disk bandwidth micro-benchmarks on every worker
        (reference scheduler.py:7590)."""
        assert self.scheduler is not None
        return await self.scheduler.benchmark_hardware()

    async def performance_report(self, filename: str = "dtpu-report.html"
                                 ) -> str:
        """Self-contained HTML snapshot (reference scheduler.py:8077)."""
        assert self.scheduler is not None
        html = await self.scheduler.performance_report_html()

        def _write() -> None:
            with open(filename, "w") as f:
                f.write(html)

        await asyncio.get_running_loop().run_in_executor(None, _write)
        return filename

    async def eventstream_start(self) -> str:
        """Opt into per-task completion events; returns the topic name.
        The reference is tied to this client: it is released on
        disconnect even if :meth:`eventstream_stop` is never called."""
        assert self.scheduler is not None
        return await self.scheduler.eventstream_start(client=self.id)

    async def eventstream_stop(self) -> None:
        assert self.scheduler is not None
        await self.scheduler.eventstream_stop(client=self.id)

    async def profile(self, workers: list[str] | None = None,
                      start: float | None = None) -> dict:
        assert self.scheduler is not None
        return await self.scheduler.get_profile(workers=workers, start=start)

    async def publish_dataset(self, name: str, data: Any,
                              override: bool = False) -> None:
        """Publish futures/data under a name that outlives this client
        (reference client.py publish_dataset)."""
        flat: list[Future] = []
        _collect_futures(data, flat)
        assert self.scheduler is not None
        await self.scheduler.publish_put(
            name=name,
            keys=[f.key for f in flat],
            data=Serialize(data),
            override=override,
        )

    async def get_dataset(self, name: str) -> Any:
        assert self.scheduler is not None
        out = await self.scheduler.publish_get(name=name)
        if out is None:
            raise KeyError(f"dataset {name!r} not found")
        data = unwrap(out["data"])
        for key in out["keys"]:
            self._ensure_tracked(key)
        return _rebind_futures(data, self)

    async def list_datasets(self) -> list[str]:
        assert self.scheduler is not None
        return await self.scheduler.publish_list()

    async def unpublish_dataset(self, name: str) -> None:
        assert self.scheduler is not None
        await self.scheduler.publish_delete(name=name)

    async def who_has(self, futures: Iterable[Future] | None = None) -> dict:
        assert self.scheduler is not None
        keys = [f.key for f in futures] if futures is not None else None
        return await self.scheduler.who_has(keys=keys)

    async def has_what(self, workers: list[str] | None = None) -> dict:
        assert self.scheduler is not None
        return await self.scheduler.has_what(workers=workers)

    async def ncores(self, workers: list[str] | None = None) -> dict:
        assert self.scheduler is not None
        return await self.scheduler.ncores(workers=workers)

    nthreads = ncores

    async def scheduler_info(self) -> dict:
        assert self.scheduler is not None
        self._scheduler_identity = await self.scheduler.identity()
        return self._scheduler_identity

    async def wait_for_workers(
        self, n_workers: int, timeout: float | None = None
    ) -> None:
        """Block until ``n_workers`` are registered and running
        (reference client.py wait_for_workers)."""
        deadline = (time() + timeout) if timeout is not None else None
        while True:
            info = await self.scheduler_info()
            workers = info.get("workers", {})
            running = sum(
                1 for w in workers.values()
                if w.get("status", "running") == "running"
            )
            if running >= n_workers:
                return
            if deadline is not None and time() > deadline:
                raise TimeoutError(
                    f"only {running}/{n_workers} workers after {timeout}s"
                )
            await asyncio.sleep(0.05)

    def get_executor(self, **kwargs: Any):
        """concurrent.futures.Executor facade (reference client.py
        get_executor)."""
        from distributed_tpu_torch.client.cfexecutor import ClientExecutor

        return ClientExecutor(self, **kwargs)

    def __repr__(self) -> str:
        return f"<Client {self.id!r} {self.status} scheduler={self.address!r}>"

    def _repr_html_(self) -> str:
        """Notebook widget (the reference's jinja2 ``widgets/`` role):
        connection summary plus the worker/thread/memory rollup from the
        last ``scheduler_info()`` snapshot (repr must not block)."""
        def format_bytes(n: float) -> str:
            for unit in ("B", "kiB", "MiB", "GiB", "TiB"):
                if n < 1024 or unit == "TiB":
                    return f"{n:.2f} {unit}"
                n /= 1024
            return f"{n:.2f} TiB"  # pragma: no cover

        rows = [
            ("Status", str(self.status)),
            ("Scheduler", str(self.address)),
        ]
        info = self._scheduler_identity or {}
        workers = info.get("workers", {})
        if workers:
            rows.append(("Workers", str(len(workers))))
            rows.append((
                "Threads",
                str(sum(w.get("nthreads", 0) for w in workers.values())),
            ))
            mem = sum(w.get("memory_limit") or 0 for w in workers.values())
            if mem:
                rows.append(("Memory", format_bytes(mem)))
        dash = info.get("dashboard")
        if dash:
            rows.append(("Dashboard", f'<a href="{dash}">{dash}</a>'))
        body = "".join(
            f"<tr><th style='text-align:left'>{k}</th><td>{v}</td></tr>"
            for k, v in rows
        )
        return (
            f"<h4 style='margin-bottom:0'>Client {self.id}</h4>"
            f"<table>{body}</table>"
        )


# ------------------------------------------------------------ helpers


def _futures_to_refs(obj: Any) -> Any:
    """Deep-replace Future objects with TaskRef markers."""
    if isinstance(obj, Future):
        return TaskRef(obj.key)
    if isinstance(obj, tuple):
        return tuple(_futures_to_refs(o) for o in obj)
    if isinstance(obj, list):
        return [_futures_to_refs(o) for o in obj]
    if isinstance(obj, dict):
        return {k: _futures_to_refs(v) for k, v in obj.items()}
    return obj


def _rebind_futures(obj: Any, client: "Client") -> Any:
    """Re-point unpickled Future objects at this client."""
    if isinstance(obj, Future):
        return Future(obj.key, client)
    if isinstance(obj, tuple):
        return tuple(_rebind_futures(o, client) for o in obj)
    if isinstance(obj, list):
        return [_rebind_futures(o, client) for o in obj]
    if isinstance(obj, (set, frozenset)):
        return type(obj)(_rebind_futures(o, client) for o in obj)
    if isinstance(obj, dict):
        return {k: _rebind_futures(v, client) for k, v in obj.items()}
    return obj


def _collect_futures(obj: Any, out: list[Future]) -> None:
    if isinstance(obj, Future):
        out.append(obj)
    elif isinstance(obj, (list, tuple, set)):
        for o in obj:
            _collect_futures(o, out)
    elif isinstance(obj, dict):
        for v in obj.values():
            _collect_futures(v, out)


def _substitute_futures(obj: Any, data: dict[Key, Any], errors: str) -> Any:
    if isinstance(obj, Future):
        return data.get(obj.key)
    if isinstance(obj, tuple):
        return tuple(_substitute_futures(o, data, errors) for o in obj)
    if isinstance(obj, list):
        return [_substitute_futures(o, data, errors) for o in obj]
    if isinstance(obj, set):
        return {_substitute_futures(o, data, errors) for o in obj}
    if isinstance(obj, dict):
        return {k: _substitute_futures(v, data, errors) for k, v in obj.items()}
    return obj


def tokenize_data(v: Any) -> str:
    return tokenize(type(v).__name__, repr(v)[:1000])


async def wait(futures: Any, timeout: float | None = None,
               return_when: str = "ALL_COMPLETED") -> Any:
    """Block until futures finish (reference client.py wait)."""
    flat: list[Future] = []
    _collect_futures(futures, flat)

    async def _one(f: Future):
        st = f.client.futures.get(f.key)
        if st is not None:
            await st.event.wait()
        return f

    if return_when == "FIRST_COMPLETED":
        done_set, pending = set(), set(flat)
        tasks = {asyncio.ensure_future(_one(f)): f for f in flat}
        done, not_done = await asyncio.wait(
            tasks, timeout=timeout, return_when=asyncio.FIRST_COMPLETED
        )
        for t in not_done:
            t.cancel()
        for t in done:
            done_set.add(tasks[t])
            pending.discard(tasks[t])
        return _DoneAndNotDone(done_set, pending)
    await asyncio.wait_for(
        asyncio.gather(*(_one(f) for f in flat)), timeout
    )
    return _DoneAndNotDone(set(flat), set())


class _DoneAndNotDone:
    def __init__(self, done: set, not_done: set):
        self.done = done
        self.not_done = not_done


class as_completed:
    """Iterate over futures in completion order (reference client.py:~5600)."""

    def __init__(self, futures: Iterable[Future] = (), *, with_results: bool = False):
        self.with_results = with_results
        self.queue: asyncio.Queue = asyncio.Queue()
        self.count = 0
        for f in futures:
            self.add(f)

    def add(self, future: Any) -> None:
        self.count += 1

        async def _watch(f: Any = future):
            if hasattr(f, "client"):  # task Future
                st = f.client.futures.get(f.key)
                if st is not None:
                    await st.event.wait()
                if self.with_results:
                    try:
                        result = await f.result()
                    except BaseException as e:  # noqa: B036
                        result = e
                    await self.queue.put((f, result))
                else:
                    await self.queue.put(f)
                return
            # ActorFuture (or any awaitable handle): completion IS the
            # await (reference actor futures iterate with as_completed
            # next to task futures)
            try:
                result = await f
            except BaseException as e:  # noqa: B036
                result = e
            if self.with_results:
                await self.queue.put((f, result))
            else:
                await self.queue.put(f)

        asyncio.ensure_future(_watch())

    def __aiter__(self) -> "as_completed":
        return self

    async def __anext__(self):
        if self.count == 0:
            raise StopAsyncIteration
        self.count -= 1
        return await self.queue.get()
