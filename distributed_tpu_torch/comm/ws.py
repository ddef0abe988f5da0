"""WebSocket comm backend (reference comm/ws.py).

Minimal RFC 6455 over asyncio streams — no web-framework dependency.
Each protocol message (the same ``dumps`` frame list as tcp) is packed
into ONE binary WebSocket message with internal length prefixes:

    uint64 n_frames, uint64 length[n], frame bytes...

Client->server frames are masked per the RFC; fragmentation uses 8 MiB
continuation frames like the reference's shards (comm/ws.py 8MiB).
Useful where only HTTP-shaped traffic traverses a proxy/ingress.

The port's copy of ``distributed_tpu/comm/ws.py``, line for line: the
frames it carries are the port's wire (``protocol.dumps``: the ``marshal``
header behind its ``PREFIX``, CUDA tensors in the ``"torch"`` family), and
the receive side uses the port's ``protocol/buffers.py`` pool and limits.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import os
import struct
from typing import Any, Callable

from distributed_tpu_torch.comm.addressing import parse_host_port, unparse_host_port
from distributed_tpu_torch.comm.core import Backend, Comm, Connector, Listener, register_backend
from distributed_tpu_torch.comm.tcp import (
    MAX_FRAME_COUNT,
    readinto_exactly,
    scatter_frames,
)
from distributed_tpu_torch.exceptions import CommClosedError, FatalCommClosedError
from distributed_tpu_torch.protocol import dumps, loads
from distributed_tpu_torch.protocol.buffers import WIRE, max_message_bytes, recv_pool

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
_u64 = struct.Struct("<Q")
FRAGMENT_SIZE = 8 * 2**20  # reference comm/ws.py shards at 8 MiB


def _accept_key(key: str) -> str:
    return base64.b64encode(
        hashlib.sha1((key + _GUID).encode()).digest()
    ).decode()


async def _read_ws_message(
    reader: asyncio.StreamReader,
    pong: Callable[[bytes], None] | None = None,
) -> tuple[memoryview, bytearray | None]:
    """Read one complete (possibly fragmented) binary message; answers
    pings via ``pong`` (RFC 6455 §5.5.2 — proxies health-check with them).

    Returns ``(payload_view, pool_buf)``: a single-fragment message —
    the common case, since our own sender only fragments above 8 MiB —
    lands in one pooled buffer via ``readinto`` (unmasked in place);
    ``pool_buf`` must be released by the caller after parsing.
    Fragmented messages gather into one bytearray (``pool_buf`` None).
    """
    parts: bytearray | None = None
    total = 0
    limit = max_message_bytes()
    while True:
        idle = parts is None and total == 0
        try:
            head = await reader.readexactly(2)
        except asyncio.CancelledError as e:
            if idle:
                # readexactly is all-or-nothing: a cancelled wait before
                # any data fragment leaves the stream at a frame
                # boundary — the comm is still usable (teardown paths
                # cancel pending reads on comms they then close cleanly)
                e._dtpu_idle_cancel = True
            raise
        fin = head[0] & 0x80
        opcode = head[0] & 0x0F
        masked = head[1] & 0x80
        length = head[1] & 0x7F
        if length == 126:
            (length,) = struct.unpack(">H", await reader.readexactly(2))
        elif length == 127:
            (length,) = struct.unpack(">Q", await reader.readexactly(8))
        if opcode in (0x8, 0x9, 0xA):
            if length > 125:
                # RFC 6455 §5.5: control payloads cap at 125 bytes and
                # never use extended lengths — a longer one is a
                # corrupt/hostile header, not a big message, so it must
                # not reach the readexactly allocation below
                raise CommClosedError(
                    f"ws control frame of {length} bytes"
                )
            mask = await reader.readexactly(4) if masked else None
            payload = await reader.readexactly(length) if length else b""
            if mask:
                # graft-lint: allow[wire-no-copy] tiny control frame; RFC masking is a transform, not a payload copy
                payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
            if opcode == 0x8:  # close
                raise CommClosedError("ws close frame")
            if opcode == 0x9 and pong is not None:  # ping -> echo payload
                pong(payload)
            continue
        total += length
        if total > limit:
            raise CommClosedError(
                f"ws message exceeds comm.max-message-bytes ({limit})"
            )
        mask = await reader.readexactly(4) if masked else None
        if parts is None and fin:
            # single-fragment fast path: pooled buffer + readinto,
            # unmasked in place — no per-message allocation, no copy
            buf = recv_pool().acquire(length)
            view = memoryview(buf)[:length]
            try:
                if length:
                    await readinto_exactly(reader, view)
                    if mask:
                        _unmask_into(view, mask)
            except BaseException:
                view = None  # release the export before the pool probe
                recv_pool().release(buf)
                raise
            return view, buf
        payload = await reader.readexactly(length) if length else b""
        if mask:
            payload = _unmask(payload, mask)
        if parts is None:
            parts = bytearray()
        parts += payload
        if fin:
            return memoryview(parts), None


def _unmask(payload: bytes, mask: bytes) -> bytes:
    import numpy as np

    data = np.frombuffer(payload, np.uint8).copy()
    m = np.frombuffer((mask * ((len(payload) + 3) // 4))[: len(payload)], np.uint8)
    return (data ^ m).tobytes()


def _unmask_into(view: memoryview, mask: bytes) -> None:
    """XOR-unmask ``view`` in place (no output allocation)."""
    import numpy as np

    data = np.frombuffer(view, np.uint8)
    m = np.frombuffer((mask * ((len(data) + 3) // 4))[: len(data)], np.uint8)
    data ^= m


def _mask_payload(payload: bytes, mask: bytes) -> bytes:
    # control frames only: payloads are RFC-capped at 125 bytes (the
    # data plane masks in place via _unmask_into)
    # graft-lint: allow[wire-no-copy] tiny control frame; RFC masking is a transform, not a payload copy
    return bytes(b ^ mask[i % 4] for i, b in enumerate(payload))


def _ws_head(flags: int, length: int, mkey: bytes | None) -> bytearray:
    """One WebSocket frame header."""
    head = bytearray([flags])
    mask_bit = 0x80 if mkey is not None else 0
    if length < 126:
        head.append(mask_bit | length)
    elif length < 65536:
        head.append(mask_bit | 126)
        head += struct.pack(">H", length)
    else:
        head.append(mask_bit | 127)
        head += struct.pack(">Q", length)
    if mkey is not None:
        head += mkey
    return head


class _PieceCursor:
    """Walk a scatter list as one logical byte string, zero-copy."""

    def __init__(self, bufs: list):
        self._bufs = [
            b if isinstance(b, memoryview) else memoryview(b) for b in bufs
        ]
        self._i = 0
        self._off = 0

    def take(self, n: int) -> list[memoryview]:
        out: list[memoryview] = []
        while n:
            mv = self._bufs[self._i]
            avail = mv.nbytes - self._off
            if not avail:
                self._i += 1
                self._off = 0
                continue
            t = min(avail, n)
            out.append(mv[self._off : self._off + t])
            self._off += t
            n -= t
        return out


class WS(Comm):
    scheme = "ws"

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 local_addr: str, peer_addr: str, *, is_client: bool,
                 deserialize: bool = True):
        super().__init__(deserialize=deserialize)
        self._reader = reader
        self._writer = writer
        self._local_addr = local_addr
        self._peer_addr = peer_addr
        self._is_client = is_client  # clients mask their frames
        self._closed = False
        self._write_lock = asyncio.Lock()

    def _send_pong(self, payload: bytes) -> None:
        try:
            head = bytearray([0x8A])  # FIN + pong
            n = len(payload)
            if self._is_client:
                head.append(0x80 | n)
                mkey = os.urandom(4)
                head += mkey
                payload = _mask_payload(payload, mkey)
            else:
                head.append(n)
            # graft-lint: allow[wire-no-copy] pong control frame is <=125 bytes by RFC
            self._writer.write(bytes(head) + payload)
        except Exception:
            pass

    async def read(self) -> Any:
        payload = pool_buf = ro = frames = None
        try:
            try:
                payload, pool_buf = await _read_ws_message(
                    self._reader, pong=self._send_pong
                )
            except (asyncio.IncompleteReadError, ConnectionResetError, OSError,
                    CommClosedError) as e:
                self.abort()
                raise CommClosedError(f"ws read failed: {e!r}") from e
            except BaseException as e:
                if getattr(e, "_dtpu_idle_cancel", False):
                    raise  # cancelled idle wait — still at a frame boundary
                # anything else (MemoryError from the pool acquire,
                # cancellation mid-frame): ws frame headers are already
                # consumed, so the stream is desynced
                self.abort()
                raise
            try:
                (n_frames,) = _u64.unpack(payload[:8])
                if n_frames > MAX_FRAME_COUNT:
                    raise CommClosedError(f"bad frame count {n_frames}")
                lengths = struct.unpack_from(f"<{n_frames}Q", payload, 8)
                WIRE.bytes_recv += payload.nbytes
                ro = payload.toreadonly()
                frames = []
                offset = 8 + 8 * n_frames
                for n in lengths:
                    frames.append(ro[offset : offset + n])
                    offset += n
                return loads(frames, deserializers=self.deserialize)
            except struct.error as e:
                # corrupt preamble (short payload, bogus counts): same
                # orderly-disconnect surface as the tcp guards
                self.abort()
                raise CommClosedError(f"ws corrupt preamble: {e!r}") from e
            except Exception:
                self.abort()
                raise
        finally:
            # drop our exports, then offer the pooled buffer back (the
            # pool's probe keeps it out of circulation while any
            # deserialized value still views it — docs/wire.md)
            payload = ro = frames = None
            if pool_buf is not None:
                recv_pool().release(pool_buf)

    async def write(self, msg: Any, on_error: str = "message") -> int:
        compression = self.handshake_options.get("compression", "auto")
        frames = dumps(msg, compression=compression)
        bufs, total = scatter_frames(frames)
        cursor = _PieceCursor(bufs)
        n_frag = max(1, -(-total // FRAGMENT_SIZE))
        wire_bytes = 0
        async with self._write_lock:
            try:
                sent = 0
                for i in range(n_frag):
                    frag_len = min(FRAGMENT_SIZE, total - sent)
                    flags = (0x80 if i == n_frag - 1 else 0) | (
                        0x2 if i == 0 else 0x0
                    )
                    pieces = cursor.take(frag_len)
                    if self._is_client:
                        # RFC 6455 client frames mask every byte: the
                        # one place the ws data plane must materialize
                        mkey = os.urandom(4)
                        WIRE.payload_copies += 1
                        import numpy as np

                        # np.empty, not bytearray: no zero-fill memset
                        # of up to 8 MiB that the gather loop below
                        # fully overwrites anyway
                        body = memoryview(np.empty(frag_len, np.uint8))
                        pos = 0
                        for p in pieces:
                            body[pos : pos + p.nbytes] = p
                            pos += p.nbytes
                        _unmask_into(body, mkey)  # xor is symmetric
                        head = _ws_head(flags, frag_len, mkey)
                        self._writer.write(head)
                        self._writer.write(body)
                    else:
                        head = _ws_head(flags, frag_len, None)
                        self._writer.write(head)
                        for p in pieces:
                            self._writer.write(p)
                    wire_bytes += len(head) + frag_len
                    sent += frag_len
                await self._writer.drain()
            except (ConnectionResetError, BrokenPipeError, RuntimeError,
                    OSError) as e:
                self.abort()
                raise CommClosedError(f"ws write failed: {e!r}") from e
        WIRE.bytes_sent += wire_bytes
        return wire_bytes

    async def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            # close frame (masked if client)
            self._writer.write(
                b"\x88\x80" + os.urandom(4) if self._is_client else b"\x88\x00"
            )
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


class WSListener(Listener):
    prefix = "ws"

    def __init__(self, loc: str, handle_comm: Callable, deserialize: bool = True,
                 **kwargs: Any):
        self.loc = loc
        self.handle_comm = handle_comm
        self.deserialize = deserialize
        self._server: asyncio.AbstractServer | None = None
        self.bound_port: int | None = None

    async def start(self) -> None:
        host, port = parse_host_port(self.loc, 0)
        self._server = await asyncio.start_server(
            self._handle_connection, host or "127.0.0.1", port
        )
        self.bound_port = self._server.sockets[0].getsockname()[1]

    async def _handle_connection(self, reader: asyncio.StreamReader,
                                 writer: asyncio.StreamWriter) -> None:
        try:
            # HTTP upgrade handshake
            request = await asyncio.wait_for(reader.readline(), 10)
            headers = {}
            while True:
                line = await asyncio.wait_for(reader.readline(), 10)
                if line in (b"\r\n", b"\n", b""):
                    break
                k, _, v = line.decode("latin1").partition(":")
                headers[k.strip().lower()] = v.strip()
            key = headers.get("sec-websocket-key")
            if not key or b"GET" not in request:
                writer.write(b"HTTP/1.1 400 Bad Request\r\n\r\n")
                await writer.drain()
                writer.close()
                return
            writer.write(
                (
                    "HTTP/1.1 101 Switching Protocols\r\n"
                    "Upgrade: websocket\r\n"
                    "Connection: Upgrade\r\n"
                    f"Sec-WebSocket-Accept: {_accept_key(key)}\r\n"
                    "\r\n"
                ).encode()
            )
            await writer.drain()
        except (asyncio.TimeoutError, OSError):
            writer.close()
            return
        peer = writer.get_extra_info("peername") or ("unknown", 0)
        comm = WS(
            reader, writer,
            local_addr=self.contact_address,
            peer_addr=f"ws://{peer[0]}:{peer[1]}",
            is_client=False,
            deserialize=self.deserialize,
        )
        try:
            await self.on_connection(comm)
        except CommClosedError:
            return
        await self.handle_comm(comm)

    def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            self._server = None

    @property
    def listen_address(self) -> str:
        host, _ = parse_host_port(self.loc, 0)
        return f"ws://{unparse_host_port(host or '127.0.0.1', self.bound_port)}"

    @property
    def contact_address(self) -> str:
        return self.listen_address


class WSConnector(Connector):
    async def connect(self, address: str, deserialize: bool = True,
                      **kwargs: Any) -> Comm:
        host, port = parse_host_port(address, 80)
        try:
            reader, writer = await asyncio.open_connection(host, port)
        except OSError as e:
            raise CommClosedError(f"ws connect to {address} failed: {e}") from e
        key = base64.b64encode(os.urandom(16)).decode()
        writer.write(
            (
                f"GET / HTTP/1.1\r\n"
                f"Host: {host}:{port}\r\n"
                "Upgrade: websocket\r\n"
                "Connection: Upgrade\r\n"
                f"Sec-WebSocket-Key: {key}\r\n"
                "Sec-WebSocket-Version: 13\r\n"
                "\r\n"
            ).encode()
        )
        await writer.drain()
        status = await reader.readline()
        if b"101" not in status:
            writer.close()
            raise FatalCommClosedError(f"ws handshake rejected: {status!r}")
        accept = None
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode("latin1").partition(":")
            if k.strip().lower() == "sec-websocket-accept":
                accept = v.strip()
        if accept != _accept_key(key):
            writer.close()
            raise FatalCommClosedError("ws handshake: bad accept key")
        sock = writer.get_extra_info("sockname")
        return WS(
            reader, writer,
            local_addr=f"ws://{sock[0]}:{sock[1]}" if sock else "ws://local",
            peer_addr=f"ws://{host}:{port}",
            is_client=True,
            deserialize=deserialize,
        )


class WSBackend(Backend):
    def get_connector(self) -> Connector:
        return WSConnector()

    def get_listener(self, loc: str, handle_comm: Callable, deserialize: bool,
                     **kwargs: Any) -> Listener:
        return WSListener(loc, handle_comm, deserialize, **kwargs)

    def get_address_host(self, loc: str) -> str:
        return parse_host_port(loc, 0)[0]

    def get_local_address_for(self, loc: str) -> str:
        return "ws://" + loc


register_backend("ws", WSBackend())
