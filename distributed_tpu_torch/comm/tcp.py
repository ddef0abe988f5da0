"""TCP / TLS comm backend over asyncio streams.

Wire format per message (reference comm/tcp.py:372 shape):

    uint64  n_frames
    uint64  length[n_frames]
    bytes   frame[0] ... frame[n_frames-1]

Frames come from ``protocol.dumps`` (msgpack header + body + payload).
Zero-copy contract (docs/wire.md): the send side builds one scatter
list — packed preamble plus the frames as-is — and hands memoryviews
straight to the transport (small pieces coalesce into the preamble to
bound syscalls; payload-sized frames are NEVER materialized).  The
receive side reads the whole payload section into one pooled contiguous
buffer and carves frames as read-only memoryview slices.  TLS wraps the
same streams with an ``ssl.SSLContext`` built by
``distributed_tpu_torch.security.Security``.
"""

from __future__ import annotations

import asyncio
import socket
import struct
from typing import Any, Callable

from distributed_tpu_torch import config
from distributed_tpu_torch.comm.addressing import parse_host_port, unparse_host_port
from distributed_tpu_torch.comm.core import Backend, Comm, Connector, Listener, register_backend
from distributed_tpu_torch.exceptions import CommClosedError, FatalCommClosedError
from distributed_tpu_torch.protocol import dumps, loads
from distributed_tpu_torch.protocol.buffers import WIRE, max_message_bytes, recv_pool

_u64 = struct.Struct("<Q")

MAX_FRAME_COUNT = 2**20  # sanity bound on header

#: frames at or below this coalesce into the preamble write (one small
#: gather copy instead of one syscall-sized write per tiny frame); above
#: it a frame always rides the wire as its own zero-copy buffer
COALESCE_MAX = 4096


def scatter_frames(frames: list) -> tuple[list, int]:
    """Build the scatter list for one message: packed preamble + frames.

    Returns ``(buffers, total_bytes)``.  Small frames are gathered into
    the preamble bytearray; large frames append as memoryviews with no
    materialization (the ``dtpu_wire_payload_copies`` contract)."""
    lengths = []
    views = []
    for f in frames:
        if isinstance(f, (bytes, bytearray)):
            lengths.append(len(f))
            views.append(f)
            continue
        mv = f if isinstance(f, memoryview) else memoryview(f)
        if mv.format != "B" or mv.ndim != 1:
            mv = mv.cast("B")
        lengths.append(mv.nbytes)
        views.append(mv)
    head = bytearray(_u64.pack(len(views)))
    head += struct.pack(f"<{len(views)}Q", *lengths)
    total = len(head) + sum(lengths)  # before coalescing grows `head`
    out: list = [head]
    # only ever extend scratch bytearrays WE created (head, or a fresh
    # coalesce buffer): a large caller-owned bytearray frame sits in
    # `out` too, and growing it would corrupt the caller's data
    scratch: bytearray | None = head
    for n, v in zip(lengths, views):
        if n > COALESCE_MAX:
            out.append(v)
            scratch = None
        elif scratch is not None:
            scratch += v
        else:
            scratch = bytearray(v)
            out.append(scratch)
    return out, total


async def readinto_exactly(reader: asyncio.StreamReader, view: memoryview) -> None:
    """Fill ``view`` from the stream — the ``readinto`` asyncio's
    StreamReader never grew.  Drains the reader's internal buffer
    directly (one user-space copy, no per-read allocation); falls back
    to chunked public-API reads if the internals ever move."""
    n = view.nbytes
    pos = 0
    buf = getattr(reader, "_buffer", None)
    if buf is None or not hasattr(reader, "_wait_for_data"):
        while pos < n:  # pragma: no cover - exercised only off-CPython
            chunk = await reader.read(n - pos)
            if not chunk:
                # graft-lint: allow[wire-no-copy] error-path partial for IncompleteReadError, connection is dead
                raise asyncio.IncompleteReadError(bytes(view[:pos]), n)
            view[pos : pos + len(chunk)] = chunk
            pos += len(chunk)
        return
    while pos < n:
        # set_exception with no pending waiter (peer RST between reads)
        # leaves _buffer empty and _eof unset: without this check the
        # _wait_for_data below would block forever.  readexactly makes
        # the same raise-before-drain check.
        exc = reader.exception()
        if exc is not None:
            raise exc
        if not buf:
            if reader.at_eof():
                # graft-lint: allow[wire-no-copy] error-path partial for IncompleteReadError, connection is dead
                raise asyncio.IncompleteReadError(bytes(view[:pos]), n)
            await reader._wait_for_data("readinto_exactly")
            continue
        take = min(len(buf), n - pos)
        with memoryview(buf) as src:  # released before the resize below
            view[pos : pos + take] = src[:take]
        del buf[:take]
        reader._maybe_resume_transport()
        pos += take


def _set_tcp_options(sock: socket.socket) -> None:
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)


class TCP(Comm):
    scheme = "tcp"

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 local_addr: str, peer_addr: str, deserialize: bool = True):
        super().__init__(deserialize=deserialize)
        self._reader = reader
        self._writer = writer
        self._local_addr = local_addr
        self._peer_addr = peer_addr
        self._closed = False
        self._write_lock = asyncio.Lock()

    async def read(self) -> Any:
        buf = view = ro = frames = None
        try:
            try:
                head = await self._reader.readexactly(8)
            except (asyncio.IncompleteReadError, ConnectionResetError,
                    BrokenPipeError, OSError) as e:
                self.abort()
                raise CommClosedError(f"read failed: {e!r}") from e
            # CancelledError above propagates WITHOUT abort: readexactly
            # is all-or-nothing, so a cancelled idle wait leaves the
            # stream at a message boundary and the comm reusable —
            # teardown paths cancel pending reads on comms they then
            # close in an orderly way
            try:
                (n_frames,) = _u64.unpack(head)
                if n_frames > MAX_FRAME_COUNT:
                    raise CommClosedError(f"bad frame count {n_frames}")
                lengths_raw = await self._reader.readexactly(8 * n_frames)
                lengths = struct.unpack(f"<{n_frames}Q", lengths_raw)
                total = sum(lengths)
                if total > max_message_bytes():
                    raise CommClosedError(
                        f"message of {total} bytes exceeds "
                        f"comm.max-message-bytes ({max_message_bytes()})"
                    )
                # one pooled contiguous buffer for the whole payload
                # section; frames are read-only zero-copy slices of it
                buf = recv_pool().acquire(total)
                view = memoryview(buf)[:total]
                await readinto_exactly(self._reader, view)
                WIRE.bytes_recv += total + 8 + 8 * n_frames
                ro = view.toreadonly()
                frames = []
                off = 0
                for n in lengths:
                    frames.append(ro[off : off + n])
                    off += n
            except CommClosedError:
                # our own guards (frame count / message size): the
                # stream is desynced — abort, don't re-wrap
                self.abort()
                raise
            except (asyncio.IncompleteReadError, ConnectionResetError,
                    BrokenPipeError, OSError) as e:
                self.abort()
                raise CommClosedError(f"read failed: {e!r}") from e
            except BaseException:
                # anything else (MemoryError from the pool acquire,
                # cancellation mid-message): the 8-byte count header is
                # already consumed, so the stream is desynced — the
                # next read would parse payload bytes as a frame count
                self.abort()
                raise
            try:
                return loads(frames, deserializers=self.deserialize)
            except Exception:
                self.abort()
                raise
        finally:
            # drop our exports before offering the buffer back: if the
            # message pinned zero-copy views (numpy frames, opaque
            # Serialized payloads) the pool's export probe drops the
            # buffer instead of ever reusing it under a live view
            view = ro = frames = None
            if buf is not None:
                recv_pool().release(buf)

    async def write(self, msg: Any, on_error: str = "message") -> int:
        compression = self.handshake_options.get("compression", "auto")
        try:
            frames = dumps(msg, compression=compression)
        except Exception as e:
            if on_error == "raise":
                raise
            from distributed_tpu_torch.utils import format_exception

            # graft-lint: allow[handler-parity] comm-layer sentinel surfaced to the reader, not a dispatched op
            frames = dumps({"op": "protocol-error", "error": format_exception(e)})
        bufs, total = scatter_frames(frames)
        async with self._write_lock:
            try:
                for b in bufs:
                    self._writer.write(b)
                await self._writer.drain()
            except (ConnectionResetError, BrokenPipeError, RuntimeError, OSError) as e:
                self.abort()
                raise CommClosedError(f"write failed: {e!r}") from e
        WIRE.bytes_sent += total
        return total

    async def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            if self._writer.can_write_eof():
                self._writer.write_eof()
            self._writer.close()
            await asyncio.wait_for(self._writer.wait_closed(), 1.0)
        except Exception:
            pass

    def abort(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                self._writer.transport.abort()
            except Exception:
                pass

    @property
    def local_address(self) -> str:
        return self._local_addr

    @property
    def peer_address(self) -> str:
        return self._peer_addr

    @property
    def closed(self) -> bool:
        return self._closed or self._reader.at_eof()


class TLS(TCP):
    scheme = "tls"


def _sock_addrs(writer: asyncio.StreamWriter, scheme: str) -> tuple[str, str]:
    sock = writer.get_extra_info("sockname")
    peer = writer.get_extra_info("peername")

    def fmt(sa):
        if sa is None:
            return f"{scheme}://<closed>"
        host, port = sa[0], sa[1]
        return f"{scheme}://{unparse_host_port(host, port)}"

    return fmt(sock), fmt(peer)


class TCPConnector(Connector):
    scheme = "tcp"
    ssl_context = None
    use_ssl = False  # the SCHEME decides: tcp:// never handshakes TLS,
    # even when connection_args carry an ssl_context (a secured client
    # talking to a plain endpoint must not TLS a plaintext listener)

    async def connect(self, address: str, deserialize: bool = True, **kwargs: Any) -> Comm:
        host, port = parse_host_port(address)
        ssl_ctx = (
            kwargs.get("ssl_context", self.ssl_context)
            if self.use_ssl else None
        )
        try:
            reader, writer = await asyncio.open_connection(
                host, port, ssl=ssl_ctx, limit=2**24
            )
        except ConnectionRefusedError as e:
            raise CommClosedError(f"connection refused: {address}") from e
        except (ssl_error_types()) as e:
            raise FatalCommClosedError(f"TLS failure connecting to {address}: {e!r}") from e
        sock = writer.get_extra_info("socket")
        if sock is not None and ssl_ctx is None:
            _set_tcp_options(sock)
        local, peer = _sock_addrs(writer, self.scheme)
        cls = TLS if ssl_ctx is not None else TCP
        return cls(reader, writer, local, f"{self.scheme}://{address}", deserialize)


def ssl_error_types():
    import ssl

    return (ssl.SSLError, ssl.CertificateError)


class TLSConnector(TCPConnector):
    scheme = "tls"
    use_ssl = True

    async def connect(self, address: str, deserialize: bool = True, **kwargs: Any) -> Comm:
        if kwargs.get("ssl_context") is None:
            from distributed_tpu_torch.security import Security

            kwargs["ssl_context"] = Security().get_connection_args("client").get("ssl_context")
        if kwargs["ssl_context"] is None:
            raise FatalCommClosedError("tls:// requires an ssl_context (configure comm.tls)")
        return await super().connect(address, deserialize, **kwargs)


class TCPListener(Listener):
    scheme = "tcp"

    def __init__(self, loc: str, handle_comm: Callable, deserialize: bool = True,
                 **kwargs: Any):
        host, port = parse_host_port(loc or "0.0.0.0:0")
        self.host = host or "0.0.0.0"
        self.port = port
        self.handle_comm = handle_comm
        self.deserialize = deserialize
        self.server: asyncio.AbstractServer | None = None
        # scheme decides: a tcp:// listener serves plaintext even when
        # listen_args carry an ssl_context (the address must not lie)
        self.ssl_context = (
            kwargs.get("ssl_context") if self.scheme == "tls" else None
        )
        self._comms: set[Comm] = set()

    async def _on_connection(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        sock = writer.get_extra_info("socket")
        if sock is not None and self.ssl_context is None:
            _set_tcp_options(sock)
        local, peer = _sock_addrs(writer, self.scheme)
        cls = TLS if self.ssl_context is not None else TCP
        comm = cls(reader, writer, local, peer, self.deserialize)
        try:
            await self.on_connection(comm)
        except CommClosedError:
            return
        self._comms.add(comm)
        try:
            await self.handle_comm(comm)
        finally:
            self._comms.discard(comm)

    async def start(self) -> None:
        backlog = config.get("comm.socket-backlog")
        self.server = await asyncio.start_server(
            self._on_connection, self.host, self.port or None,
            ssl=self.ssl_context, backlog=backlog, limit=2**24, reuse_address=True,
        )
        if self.port == 0:
            self.port = self.server.sockets[0].getsockname()[1]

    def stop(self) -> None:
        if self.server is not None:
            self.server.close()
            self.server = None

    @property
    def listen_address(self) -> str:
        return f"{self.scheme}://{unparse_host_port(self.host, self.port)}"

    @property
    def contact_address(self) -> str:
        host = self.host
        if host in ("0.0.0.0", ""):
            from distributed_tpu_torch.utils import get_ip

            host = get_ip()
        return f"{self.scheme}://{unparse_host_port(host, self.port)}"


class TLSListener(TCPListener):
    scheme = "tls"

    def __init__(self, loc: str, handle_comm: Callable, deserialize: bool = True,
                 **kwargs: Any):
        super().__init__(loc, handle_comm, deserialize, **kwargs)
        if self.ssl_context is None:
            from distributed_tpu_torch.security import Security

            self.ssl_context = Security().get_listen_args("scheduler").get("ssl_context")
        if self.ssl_context is None:
            raise ValueError("tls:// listener requires ssl_context (configure comm.tls)")


class TCPBackend(Backend):
    _connector_cls = TCPConnector
    _listener_cls = TCPListener

    def get_connector(self) -> Connector:
        return self._connector_cls()

    def get_listener(self, loc: str, handle_comm: Callable, deserialize: bool,
                     **kwargs: Any) -> Listener:
        return self._listener_cls(loc, handle_comm, deserialize, **kwargs)


class TLSBackend(TCPBackend):
    _connector_cls = TLSConnector
    _listener_cls = TLSListener


register_backend("tcp", TCPBackend())
register_backend("tls", TLSBackend())
