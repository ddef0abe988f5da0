"""RPC server skeleton: handler dispatch over comms.

Reference shape (core.py:285 ``Server``): a node exposes two handler maps —

- ``handlers``:        request/response ops. A comm sends
  ``{"op": name, "reply": True, **kwargs}`` and awaits one response.
- ``stream_handlers``: one-way ops arriving over long-lived batched streams
  (``handle_stream``), the scheduler<->worker and scheduler<->client event
  channels.

Plus the client side: ``rpc(addr).op_name(**kwargs)`` sugar backed by a
``ConnectionPool`` that reuses comms with limits.

Differences from the reference: asyncio-native throughout (no tornado);
handler results may be coroutines or plain values; errors are shipped back
as picklable exception payloads and re-raised remotely.
"""

from __future__ import annotations

import asyncio
import inspect
import logging
import sys
import traceback
import weakref
from collections.abc import Awaitable, Callable, Collection
from enum import Enum
from typing import Any

from distributed_tpu_torch import config
from distributed_tpu_torch.comm import connect, listen
from distributed_tpu_torch.comm.core import Comm
from distributed_tpu_torch.exceptions import CommClosedError
from distributed_tpu_torch.protocol import Serialize
from distributed_tpu_torch.protocol import pickle as _pickle
from distributed_tpu_torch.tracing import FlightRecorder
from distributed_tpu_torch.utils import funcname, time
from distributed_tpu_torch.utils.misc import seq_name

logger = logging.getLogger("distributed_tpu_torch.rpc")


class Status(Enum):
    """Node lifecycle (reference core.py:77)."""

    undefined = "undefined"
    created = "created"
    init = "init"
    starting = "starting"
    running = "running"
    paused = "paused"
    stopping = "stopping"
    stopped = "stopped"
    closing = "closing"
    closing_gracefully = "closing_gracefully"
    closed = "closed"
    failed = "failed"
    dont_reply = "dont_reply"


Status.lookup = {s.name: s for s in Status}  # type: ignore[attr-defined]


class AsyncTaskGroup:
    """Track background tasks for clean shutdown (reference core.py:173)."""

    def __init__(self) -> None:
        self.closed = False
        self._ongoing: set[asyncio.Task] = set()

    def call_soon(self, afunc: Callable[..., Awaitable], *args: Any, **kwargs: Any) -> None:
        if self.closed:
            return
        task = asyncio.create_task(afunc(*args, **kwargs))
        self._ongoing.add(task)
        task.add_done_callback(self._done)

    def call_later(self, delay: float, afunc: Callable[..., Awaitable], *args: Any) -> None:
        async def _later():
            await asyncio.sleep(delay)
            await afunc(*args)

        self.call_soon(_later)

    def _done(self, task: asyncio.Task) -> None:
        self._ongoing.discard(task)
        if not task.cancelled() and task.exception() is not None:
            exc = task.exception()
            if not isinstance(exc, (CommClosedError, asyncio.CancelledError)):
                logger.exception("background task failed", exc_info=exc)

    def close(self) -> None:
        self.closed = True

    async def stop(self) -> None:
        self.close()
        # never cancel the caller: close() itself often runs inside this
        # group (terminate RPC, close-worker stream op, idle-timeout)
        me = asyncio.current_task()
        pending = [t for t in self._ongoing if t is not me]
        for t in pending:
            t.cancel()
        if pending:
            await asyncio.gather(*pending, return_exceptions=True)

    def __len__(self) -> int:
        return len(self._ongoing)


class PeriodicCallback:
    """asyncio periodic callback (reference compatibility.py)."""

    def __init__(self, callback: Callable, interval_s: float):
        self.callback = callback
        self.interval = interval_s
        self._task: asyncio.Task | None = None

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._run())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    @property
    def is_running(self) -> bool:
        return self._task is not None

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval)
            try:
                res = self.callback()
                if inspect.isawaitable(res):
                    await res
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("periodic callback %s failed", funcname(self.callback))


def error_message(e: BaseException) -> dict:
    """Picklable error payload (reference core.py error_message)."""
    tb = traceback.format_exception(type(e), e, e.__traceback__)
    max_len = config.get("admin.max-error-length")
    tb_text = "".join(tb)[-max_len:]
    try:
        pickled = _pickle.dumps(e)
        _pickle.loads(pickled)
    except Exception:
        e2 = Exception(f"{type(e).__name__}: {e}")
        pickled = _pickle.dumps(e2)
    return {
        "status": "error",
        "exception": pickled,
        "traceback-text": tb_text,
        "exception-text": repr(e),
    }


def raise_remote_error(resp: dict) -> None:
    if "exception" not in resp:
        # direct callers (client report stream, actors) may pass an
        # error-status reply that carries no pickled envelope — surface
        # a clear RPCError instead of KeyError masking the message
        from distributed_tpu_torch.exceptions import RPCError

        raise RPCError(resp.get("error", resp.get("message", repr(resp))))
    exc = _pickle.loads(resp["exception"])
    if resp.get("traceback-text"):
        note = f"\n\nRemote traceback:\n{resp['traceback-text']}"
        try:
            exc.add_note(note)
        except AttributeError:  # pragma: no cover - py<3.11
            pass
    raise exc


class Server:
    """Handler-dispatch RPC server; base of Scheduler / Worker / Nanny."""

    default_ip = ""
    default_port = 0
    blocked_handlers_config_key = "scheduler.blocked-handlers"
    # node types with config-driven preloads (reference distributed.yaml
    # scheduler.preload / worker.preload / nanny.preload) set this to
    # their config prefix; CLI --preload flags are handled by the CLIs
    # and ADD to these
    preload_config_prefix: str | None = None

    def __init__(
        self,
        handlers: dict[str, Callable] | None = None,
        stream_handlers: dict[str, Callable] | None = None,
        connection_args: dict | None = None,
        deserialize: bool = True,
        name: str | None = None,
        timeout: float | None = None,
    ):
        self.handlers: dict[str, Callable] = {
            "identity": self.identity,
            "echo": self.echo,
            "connection_stream": self.handle_stream,
            "get_trace": self.get_trace,
        }
        if handlers:
            self.handlers.update(handlers)
        # per-node-type blocklist (reference worker.py blocked_handlers):
        # Worker/Nanny override blocked_handlers_config_key so each node
        # type is governed by its own config key.  Enforced at DISPATCH
        # (not by popping here): subclasses and extensions register
        # handlers after this __init__ runs, and those must be
        # blockable too.
        self._blocked_handlers = frozenset(
            config.get(self.blocked_handlers_config_key) or []
        )
        self.stream_handlers: dict[str, Callable] = dict(stream_handlers or {})
        # same-op runs within one batched-stream payload can be folded
        # into a single call: ``stream_batch_handlers[op](msgs, **extra)``
        # receives the whole run as a list of message dicts (op stripped).
        # Servers opt in per op; anything unregistered keeps the
        # per-message path below.
        self.stream_batch_handlers: dict[str, Callable] = {}
        self.connection_args = connection_args or {}
        self.deserialize = deserialize
        self.name = name
        self.id = f"{type(self).__name__}-{_new_uid()}"
        self.status = Status.created
        self.listeners: list = []
        self._comms: dict[Comm, str | None] = {}
        self._ongoing_background_tasks = AsyncTaskGroup()
        self.periodic_callbacks: dict[str, PeriodicCallback] = {}
        self.counters: dict[str, int] = {}
        self.digests: dict[str, float] = {}
        self.digests_tdigest: dict[str, Any] = {}
        self._startup_lock = asyncio.Lock()
        self._close_started = False
        self._event_finished = asyncio.Event()
        self.rpc = ConnectionPool(
            deserialize=deserialize,
            connection_args=self.connection_args,
            server=self,
        )
        # flight recorder (tracing.py): servers wrapping a state machine
        # (Scheduler, Worker) re-point this at their state's recorder
        # after construction so role HTTP routes and the sans-io engine
        # share one causal timeline.  The base-Server placeholder keeps
        # a tiny ring — nothing emits through it, and a full
        # default-size ring here would be ~MBs of dead preallocation
        # per Nanny/bare server
        self.trace = FlightRecorder(ring_size=256)
        self._start_time = time()

    # ------------------------------------------------------------ handlers

    async def identity(self) -> dict:
        return {"type": type(self).__name__, "id": self.id, "name": self.name}

    async def echo(self, data: Any = None) -> Any:
        return data

    async def get_trace(self, n: int = 200) -> list[dict]:
        """Newest flight-recorder events (JSON-safe dicts): the RPC twin
        of the HTTP ``/trace`` route, used by cluster dumps so chaos
        post-mortems ship every node's causal tail by default."""
        return self.trace.tail(n)

    # ------------------------------------------------------------ lifecycle

    @property
    def address(self) -> str:
        if self.listeners:
            return self.listeners[0].contact_address
        raise ValueError(f"{self!r} not listening yet")

    @property
    def listen_address(self) -> str:
        return self.listeners[0].listen_address

    @property
    def port(self) -> int:
        from distributed_tpu_torch.comm import get_address_host_port

        return get_address_host_port(self.address)[1]

    async def listen(self, addr: str, **kwargs: Any) -> None:
        listener = listen(addr, self._handle_comm, deserialize=self.deserialize, **kwargs)
        await listener.start()
        self.listeners.append(listener)

    async def start_unsafe(self) -> "Server":
        return self

    async def start(self) -> "Server":
        async with self._startup_lock:
            if self.status == Status.running:
                return self
            if self.status == Status.failed:
                raise RuntimeError(f"{self!r} previously failed to start")
            self.status = Status.starting
            try:
                await self.start_unsafe()
                await self._start_config_preloads()
            except Exception:
                self.status = Status.failed
                await self.close()
                raise
            self.status = Status.running
        return self

    async def _start_config_preloads(self) -> None:
        if getattr(self, "_config_preloads_started", False):
            return  # a subclass ran them at its preferred point
        self._config_preloads_started = True
        self._config_preloads: list = []
        if not self.preload_config_prefix:
            return
        from distributed_tpu_torch.preloading import process_preloads

        specs = config.get(f"{self.preload_config_prefix}.preload", None)
        argv = config.get(f"{self.preload_config_prefix}.preload-argv", None)
        self._config_preloads = process_preloads(self, specs, argv or None)
        for preload in self._config_preloads:
            await preload.start()

    async def _teardown_config_preloads(self) -> None:
        """Idempotent; subclasses call this FIRST in their close() so
        dtpu_teardown hooks still see a live cluster (matching the CLI
        flag ordering); Server.close is the backstop."""
        preloads, self._config_preloads = (
            getattr(self, "_config_preloads", []), []
        )
        for preload in preloads:
            try:
                await preload.teardown()
            except Exception:
                logger.exception("preload teardown failed")

    def start_periodic_callbacks(self) -> None:
        for pc in self.periodic_callbacks.values():
            if not pc.is_running:
                pc.start()

    async def finished(self) -> None:
        await self._event_finished.wait()

    async def close(self, timeout: float | None = None) -> None:
        # guarded by a flag, not status: subclasses set status=closing and
        # then delegate here, which must still run exactly once
        if self._close_started:
            await self._event_finished.wait()
            return
        self._close_started = True
        self.status = Status.closing
        await self._teardown_config_preloads()
        for pc in self.periodic_callbacks.values():
            pc.stop()
        self.periodic_callbacks.clear()
        for listener in self.listeners:
            listener.stop()
        for comm in list(self._comms):
            try:
                comm.abort()
            except Exception:
                pass
        await self._ongoing_background_tasks.stop()
        await self.rpc.close()
        self.status = Status.closed
        self._event_finished.set()

    async def __aenter__(self):
        await self.start()
        return self

    async def __aexit__(self, *exc):
        await self.close()

    # ----------------------------------------------------------- comm loop

    async def _handle_comm(self, comm: Comm) -> None:
        """Serve request/response ops on one comm until it closes
        (reference core.py:876)."""
        self._comms[comm] = None
        try:
            while not self.status.name.startswith("clos"):
                try:
                    msg = await comm.read()
                except CommClosedError:
                    break
                if not isinstance(msg, dict) or "op" not in msg:
                    await comm.write(error_message(
                        TypeError(f"bad message {type(msg)}: needs dict with 'op'")))
                    continue
                op = msg.pop("op")
                reply = msg.pop("reply", True)
                serializers = msg.pop("serializers", None)  # noqa: F841 - compat
                self.counters[op] = self.counters.get(op, 0) + 1
                handler = (
                    None if op in self._blocked_handlers
                    else self.handlers.get(op)
                )
                if handler is None:
                    result: Any = error_message(ValueError(
                        f"unknown operation {op!r} on {type(self).__name__}"))
                else:
                    try:
                        if _wants_comm(handler):
                            # comm handlers that write their own reply
                            # (get_data) must see the reply flag or a
                            # reply=False caller gets an unsolicited
                            # write that desyncs the pooled comm
                            if _wants_reply_flag(handler):
                                result = handler(comm, reply=reply, **msg)
                            else:
                                result = handler(comm, **msg)
                        else:
                            result = handler(**msg)
                        if inspect.isawaitable(result):
                            result = await result
                    except CommClosedError:
                        break
                    except Exception as e:
                        logger.debug("handler %s raised", op, exc_info=True)
                        result = error_message(e)
                if result is Status.dont_reply:
                    continue
                if reply:
                    try:
                        await comm.write(result)
                    except (CommClosedError, TypeError):
                        break
                if op == "connection_stream":
                    # handle_stream took over the comm and has returned:
                    # nothing more to serve
                    break
        finally:
            self._comms.pop(comm, None)
            if not comm.closed:
                await comm.close()

    async def handle_stream(self, comm: Comm, extra: dict | None = None) -> None:
        """Serve one-way batched-stream ops (reference core.py:1015)."""
        extra = extra or {}
        closed = False
        try:
            while not closed:
                msgs = await comm.read()
                if not isinstance(msgs, (tuple, list)):
                    msgs = (msgs,)
                i, n = 0, len(msgs)
                while i < n:
                    msg = msgs[i]
                    if msg == "OK":  # initial handshake ack
                        i += 1
                        continue
                    op = msg.pop("op", None)
                    if op is None:
                        raise ValueError(f"stream message without op: {msg!r}")
                    if op == "close-stream":
                        closed = True
                        break
                    batch_handler = self.stream_batch_handlers.get(op)
                    if batch_handler is not None:
                        # fold the whole consecutive same-op run (a
                        # task-finished flood, a free/release flood) into
                        # ONE dispatch: the handler sees the run as a
                        # list and drives the state machine in a single
                        # batched pass instead of once per message
                        j = i + 1
                        while (
                            j < n
                            and isinstance(msgs[j], dict)
                            and msgs[j].get("op") == op
                        ):
                            msgs[j].pop("op", None)
                            j += 1
                        batch = list(msgs[i:j])
                        i = j
                        # causal stimulus ids are minted AT INGRESS: any
                        # message folding into a batched engine pass
                        # without one (client-plane floods; worker
                        # messages always carry theirs) gets a fresh id
                        # here, so the flight recorder can join the
                        # inbound flood to the engine pass, the
                        # transitions it produced, and the envelopes
                        # those emitted (docs/observability.md)
                        for m in batch:
                            if not m.get("stimulus_id"):
                                m["stimulus_id"] = seq_name(f"igr-{op}")
                        try:
                            result = batch_handler(batch, **extra)
                            if result is not None and inspect.isawaitable(result):
                                await result
                        except Exception:
                            logger.exception(
                                "stream batch handler %r failed", op
                            )
                        continue
                    i += 1
                    handler = self.stream_handlers.get(op)
                    if handler is None:
                        logger.error("unknown stream op %r", op)
                        continue
                    try:
                        # stream context (worker=/client= address) fills in
                        # unless the message already carries the field
                        result = handler(**{**extra, **msg}) if extra else handler(**msg)
                        if result is not None and inspect.isawaitable(result):
                            await result
                    except Exception:
                        logger.exception("stream handler %r failed", op)
                # payload boundary: servers that coalesce stream stimuli
                # (the worker's event buffer) flush here, SYNCHRONOUSLY,
                # so a whole batched payload becomes one state-machine
                # batch and no locally-generated event can interleave
                flush = getattr(self, "stream_payload_flush", None)
                if flush is not None:
                    try:
                        flush()
                    except Exception:
                        logger.exception("stream payload flush failed")
        except CommClosedError:
            pass
        finally:
            await comm.close()

    # ------------------------------------------------------------- helpers

    def digest_metric(self, name: str, value: float) -> None:
        """Cumulative total + streaming quantile sketch per metric
        (reference core.py:1088; sketch = native t-digest, counter.py:40)."""
        self.digests[name] = self.digests.get(name, 0.0) + value
        digest = self.digests_tdigest.get(name)
        if digest is None:
            from distributed_tpu_torch.utils.counter import Digest

            digest = self.digests_tdigest[name] = Digest()
        digest.add(value)

    def __repr__(self) -> str:
        try:
            addr = self.address
        except ValueError:
            addr = "not-listening"
        return f"<{type(self).__name__} {addr!r} {self.status.name}>"


def _wants_reply_flag(handler: Callable) -> bool:
    cached = getattr(handler, "_wants_reply_flag", None)
    if cached is None:
        try:
            params = inspect.signature(handler).parameters
        except (TypeError, ValueError):
            params = {}
        cached = "reply" in params
        try:
            handler.__dict__["_wants_reply_flag"] = cached
        except AttributeError:
            pass
    return cached


def _wants_comm(handler: Callable) -> bool:
    cached = getattr(handler, "_wants_comm", None)
    if cached is None:
        try:
            params = list(inspect.signature(handler).parameters)
        except (TypeError, ValueError):
            params = []
        cached = bool(params) and params[0] == "comm"
        try:
            handler.__dict__["_wants_comm"] = cached
        except AttributeError:
            pass
    return cached


_uid_counter = 0


def _new_uid() -> str:
    global _uid_counter
    _uid_counter += 1
    import uuid

    return f"{uuid.uuid4().hex[:8]}-{_uid_counter}"


# ---------------------------------------------------------------------------
# Client-side RPC
# ---------------------------------------------------------------------------


class RPCCall:
    """``rpc_obj.op_name(**kwargs)`` -> send {"op": "op_name", ...}, await reply."""

    def __getattr__(self, op: str):
        async def send_recv_op(**kwargs: Any):
            return await self.send_recv(op=op, **kwargs)

        return send_recv_op


async def run_user_function(server: Any, inject_kw: str, function: Any = None,
                            args: Any = None, kwargs: Any = None,
                            wait: bool = True) -> Any:
    """Shared body of the run-arbitrary-function handlers on scheduler,
    worker, and nanny (reference run handlers): unwrap, optionally inject
    the hosting server under ``inject_kw``, await coroutines, wrap errors."""
    import inspect

    from distributed_tpu_torch.protocol.serialize import Serialize, unwrap

    fn = unwrap(function)
    a = unwrap(args) or ()
    kw = unwrap(kwargs) or {}
    try:
        if inject_kw in inspect.signature(fn).parameters:
            kw[inject_kw] = server
        result = fn(*a, **kw)
        if asyncio.iscoroutine(result):
            if wait:
                result = await result
            else:
                server._ongoing_background_tasks.call_soon(lambda: result)
                result = None
        return {"status": "OK", "result": Serialize(result)}
    except Exception as e:
        return error_message(e)


async def send_recv(comm: Comm, *, op: str, reply: bool = True, **kwargs: Any) -> Any:
    await comm.write({"op": op, "reply": reply, **kwargs})
    if not reply:
        return None
    resp = await comm.read()
    # only replies carrying a pickled exception are error ENVELOPES;
    # handlers may use status "error" as structured protocol data (e.g.
    # Scheduler.gather's missing-keys reply, which the client handles)
    if (
        isinstance(resp, dict)
        and resp.get("status") in ("error", "uncaught-error")
        and "exception" in resp
    ):
        raise_remote_error(resp)
    return resp


class rpc(RPCCall):
    """Dedicated (non-pooled) RPC proxy to one address; opens comms on
    demand and reuses idle ones (reference core.py:1201)."""

    def __init__(self, address: str, deserialize: bool = True,
                 connection_args: dict | None = None, timeout: float | None = None):
        self.address = address
        self.deserialize = deserialize
        self.connection_args = connection_args or {}
        self.timeout = timeout
        self.comms: dict[Comm, bool] = {}  # comm -> in_use
        self.status = Status.running

    async def live_comm(self) -> Comm:
        for comm, in_use in list(self.comms.items()):
            if comm.closed:
                del self.comms[comm]
            elif not in_use:
                self.comms[comm] = True
                return comm
        comm = await connect(self.address, timeout=self.timeout,
                             deserialize=self.deserialize, **self.connection_args)
        self.comms[comm] = True
        return comm

    async def send_recv(self, **kwargs: Any) -> Any:
        if self.status == Status.closed:
            raise RuntimeError(f"rpc to {self.address} is closed")
        comm = await self.live_comm()
        try:
            result = await send_recv(comm, **kwargs)
        except (CommClosedError, asyncio.CancelledError):
            self.comms.pop(comm, None)
            raise
        self.comms[comm] = False
        return result

    async def close_rpc(self) -> None:
        self.status = Status.closed
        for comm in list(self.comms):
            try:
                await comm.close()
            except Exception:
                pass
        self.comms.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        asyncio.ensure_future(self.close_rpc())

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        await self.close_rpc()

    def __repr__(self) -> str:
        return f"<rpc to {self.address!r}, {len(self.comms)} comms>"


class PooledRPCCall(RPCCall):
    """RPC proxy borrowing comms from a ConnectionPool (reference core.py:1369)."""

    def __init__(self, address: str, pool: "ConnectionPool", serializers=None):
        self.address = address
        self.pool = pool

    async def send_recv(self, **kwargs: Any) -> Any:
        comm = await self.pool.connect(self.address)
        prev_name, comm.name = comm.name, "rpc"
        try:
            result = await send_recv(comm, **kwargs)
        except BaseException:
            # cancellation or failure mid-request: the reply (if it ever
            # comes) is still in flight — returning this comm to the
            # pool would hand the NEXT caller a stale response and
            # desynchronize every later RPC on it.  Abort instead.
            comm.abort()
            self.pool.reuse(self.address, comm)  # pool discards closed comms
            comm.name = prev_name
            raise
        self.pool.reuse(self.address, comm)
        comm.name = prev_name
        return result

    def __repr__(self) -> str:
        return f"<pooled rpc to {self.address!r}>"


class ConnectionPool:
    """Comm pool with per-address reuse and a global open-connection limit
    (reference core.py ConnectionPool)."""

    def __init__(self, limit: int = 512, deserialize: bool = True,
                 connection_args: dict | None = None, timeout: float | None = None,
                 server: Server | None = None):
        self.limit = limit
        self.deserialize = deserialize
        self.connection_args = connection_args or {}
        self.timeout = timeout
        self.server = weakref.ref(server) if server else None
        self.available: dict[str, set[Comm]] = {}
        self.occupied: dict[str, set[Comm]] = {}
        self.semaphore = asyncio.Semaphore(limit)
        self._created: weakref.WeakSet = weakref.WeakSet()
        self.status = Status.init

    def __call__(self, address: str) -> PooledRPCCall:
        return PooledRPCCall(address, self)

    @property
    def active(self) -> int:
        return sum(map(len, self.occupied.values()))

    @property
    def open(self) -> int:
        return self.active + sum(map(len, self.available.values()))

    async def connect(self, address: str) -> Comm:
        if self.status == Status.closed:
            raise RuntimeError("ConnectionPool is closed")
        avail = self.available.setdefault(address, set())
        occ = self.occupied.setdefault(address, set())
        while avail:
            comm = avail.pop()
            if comm.closed:
                self.semaphore.release()
                continue
            occ.add(comm)
            return comm
        if self.semaphore.locked():
            self.collect()
        await self.semaphore.acquire()
        try:
            comm = await connect(address, timeout=self.timeout,
                                 deserialize=self.deserialize, **self.connection_args)
            comm.name = "ConnectionPool"
            self._created.add(comm)
        except BaseException:
            self.semaphore.release()
            raise
        occ.add(comm)
        return comm

    def reuse(self, address: str, comm: Comm) -> None:
        occ = self.occupied.get(address, set())
        occ.discard(comm)
        if comm.closed:
            self.semaphore.release()
        else:
            self.available.setdefault(address, set()).add(comm)

    def collect(self) -> None:
        """Drop idle comms to free slots."""
        for address, comms in list(self.available.items()):
            for comm in comms:
                comm.abort()
                self.semaphore.release()
            comms.clear()

    async def remove(self, address: str) -> None:
        for comm in self.available.pop(address, set()):
            comm.abort()
            self.semaphore.release()
        for comm in self.occupied.pop(address, set()):
            comm.abort()
            self.semaphore.release()

    async def close(self) -> None:
        self.status = Status.closed
        for d in (self.available, self.occupied):
            for comms in d.values():
                for comm in comms:
                    comm.abort()
            d.clear()


def clean_exception(exception, traceback_text: str = "") -> tuple:
    """Normalize an error payload into (type, exception, traceback_text)."""
    if isinstance(exception, (bytes, bytearray)):
        exception = _pickle.loads(exception)
    return type(exception), exception, traceback_text
