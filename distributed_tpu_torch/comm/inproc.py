"""In-process comm: queue pairs between objects in one process.

Reference comm/inproc.py: no serialization, messages pass by reference
through a pair of deques with asyncio wakeups.  Used by
``LocalCluster(processes=False)`` and unit tests.
"""

from __future__ import annotations

import asyncio
import itertools
import os
import threading
import uuid
import weakref
from collections import deque
from typing import Any, Callable

from distributed_tpu_torch.comm.core import Backend, Comm, Connector, Listener, register_backend
from distributed_tpu_torch.exceptions import CommClosedError
from distributed_tpu_torch.protocol.serialize import nested_deserialize

_counter = itertools.count()
_namespace = f"{os.getpid()}/{uuid.uuid4().hex[:8]}"

_listeners: "weakref.WeakValueDictionary[str, InProcListener]" = weakref.WeakValueDictionary()
_lock = threading.Lock()


def new_address() -> str:
    return f"inproc://{_namespace}/{next(_counter)}"


class _Channel:
    """One direction: a deque + event for the reader.

    The writer may live on a different thread/loop (sync Client inside a
    worker task, LoopRunner threads): waking the reader must then go
    through ``call_soon_threadsafe`` — a bare ``Event.set()`` from a
    foreign thread never wakes the waiting loop.
    """

    def __init__(self):
        self.queue: deque = deque()
        self.event = asyncio.Event()
        self.closed = False
        self._reader_loop: asyncio.AbstractEventLoop | None = None

    def _wake(self) -> None:
        loop = self._reader_loop
        if loop is None or loop.is_closed():
            self.event.set()
            return
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is loop:
            self.event.set()
        else:
            try:
                loop.call_soon_threadsafe(self.event.set)
            except RuntimeError:
                pass  # reader loop shut down

    def put(self, msg: Any) -> None:
        self.queue.append(msg)
        self._wake()

    async def get(self):
        self._reader_loop = asyncio.get_running_loop()
        while not self.queue:
            if self.closed:
                raise CommClosedError("inproc channel closed")
            self.event.clear()
            await self.event.wait()
        return self.queue.popleft()

    def close(self) -> None:
        self.closed = True
        self._wake()


class InProc(Comm):
    # both endpoints live in this process: connect()/on_connection skip
    # the handshake message exchange entirely
    same_process = True

    def __init__(self, local_addr: str, peer_addr: str, read_q: _Channel,
                 write_q: _Channel, deserialize: bool = True):
        super().__init__(deserialize=deserialize)
        self._local_addr = local_addr
        self._peer_addr = peer_addr
        self._read_q = read_q
        self._write_q = write_q
        self._closed = False

    async def read(self) -> Any:
        if self._closed:
            raise CommClosedError("comm closed")
        msg = await self._read_q.get()
        if msg is _CLOSE:
            self._closed = True
            raise CommClosedError("peer closed the comm")
        # Serialize leaves pass by reference; unwrap for parity with
        # networked comms (reference inproc.py same behavior).
        # nested_deserialize is copy-on-write, so payloads BELOW the top
        # level may be the sender's own objects — receivers treat message
        # contents as read-only (the reference shares leaves the same
        # way).  The top level is always copied here: handle_stream pops
        # "op" from each message, and broadcast paths (report, pubsub)
        # send one dict to many inproc streams.
        if self.deserialize:
            msg = nested_deserialize(msg)
        if type(msg) is list:
            msg = [dict(m) if type(m) is dict else m for m in msg]
        elif type(msg) is dict:
            msg = dict(msg)
        return msg

    async def write(self, msg: Any, on_error: str = "message") -> int:
        if self._closed or self._write_q.closed:
            raise CommClosedError("comm closed")
        self._write_q.put(msg)
        return 1

    async def close(self) -> None:
        self.abort()

    def abort(self) -> None:
        if not self._closed:
            self._write_q.put(_CLOSE)
            self._write_q.close()
            self._read_q.close()
            self._closed = True

    @property
    def local_address(self) -> str:
        return self._local_addr

    @property
    def peer_address(self) -> str:
        return self._peer_addr

    @property
    def closed(self) -> bool:
        return self._closed


_CLOSE = object()


class InProcListener(Listener):
    def __init__(self, loc: str | None, handle_comm: Callable, deserialize: bool = True):
        self.loc = loc or f"{_namespace}/{next(_counter)}"
        self.handle_comm = handle_comm
        self.deserialize = deserialize
        self._loop: asyncio.AbstractEventLoop | None = None

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        with _lock:
            _listeners[self.loc] = self

    def stop(self) -> None:
        with _lock:
            _listeners.pop(self.loc, None)

    async def _accept(self, comm: InProc) -> None:
        try:
            await self.on_connection(comm)
        except CommClosedError:
            return
        await self.handle_comm(comm)

    def connect_threadsafe(self, client_comm_factory) -> InProc:
        """Called from the connector (possibly another thread/loop)."""
        a2b = _Channel()
        b2a = _Channel()
        addr = f"inproc://{self.loc}"
        server_comm = InProc(addr, new_address(), a2b, b2a, self.deserialize)
        client_comm = client_comm_factory(server_comm.peer_address, addr, b2a, a2b)
        assert self._loop is not None
        self._loop.call_soon_threadsafe(
            lambda: self._loop.create_task(self._accept(server_comm))
        )
        return client_comm

    @property
    def listen_address(self) -> str:
        return f"inproc://{self.loc}"

    contact_address = listen_address


class InProcConnector(Connector):
    async def connect(self, address: str, deserialize: bool = True, **kwargs: Any) -> Comm:
        with _lock:
            listener = _listeners.get(address)
        if listener is None:
            raise CommClosedError(f"no inproc listener at {address!r}")
        comm = listener.connect_threadsafe(
            lambda local, peer, rq, wq: InProc(local, peer, rq, wq, deserialize)
        )
        return comm


class InProcBackend(Backend):
    def get_connector(self) -> Connector:
        return InProcConnector()

    def get_listener(self, loc: str, handle_comm: Callable, deserialize: bool,
                     **kwargs: Any) -> Listener:
        return InProcListener(loc or None, handle_comm, deserialize)

    def get_address_host(self, loc: str) -> str:
        return loc.split("/")[0]

    def get_local_address_for(self, loc: str) -> str:
        return new_address()


register_backend("inproc", InProcBackend())
