"""Shuffle storage layer: shard buffers with spill-to-disk, batched
outbound comms, and memory backpressure.

Equivalents of the reference's shuffle buffering stack (re-designed for
asyncio, not copied):

- ``ResourceLimiter``   — reference shuffle/_limiter.py:89
- ``ShardsBuffer`` base — reference shuffle/_buffer.py
- ``MemoryShardsBuffer``— reference shuffle/_memory.py
- ``DiskShardsBuffer``  — reference shuffle/_disk.py (append-only spill
  files per output partition, read back at unpack time)
- ``CommShardsBuffer``  — reference shuffle/_comms.py (batches outbound
  shards per destination worker)

Writers block (``await``) while the limiter is over budget, so a shuffle
can move arbitrarily more data than fits in memory: received shards
drain to disk, outbound shards drain onto the wire, and ``add_partition``
simply slows down to match.

The port's copy of ``distributed_tpu/shuffle/buffers.py``, line for line.
``_nbytes`` is the port's ``utils/sizeof.py``, so a CUDA tensor counts its
device bytes against the limiter, and the disk buffer's frames come from
the port's ``protocol.serialize.pickle_oob_frames``.
"""

from __future__ import annotations

import asyncio
import logging
import os
import pickle
import struct
from collections import defaultdict
from typing import Any, Awaitable, Callable

logger = logging.getLogger("distributed_tpu_torch.shuffle")


class ShuffleClosedError(RuntimeError):
    """The shuffle run (or one of its buffers) was torn down; task bodies
    catch this and request an epoch restart (shuffle/api.py)."""


class ResourceLimiter:
    """Async budget meter: ``acquire`` blocks while over the limit
    (reference shuffle/_limiter.py:89 semantics)."""

    def __init__(self, limit: int | None):
        self.limit = limit
        self.acquired = 0
        self._event = asyncio.Event()
        self._event.set()

    def free(self) -> bool:
        return self.limit is None or self.acquired < self.limit

    def book(self, n: int) -> None:
        """Synchronously record n units as held (may overshoot the limit;
        progress beats strictness for shards larger than the budget)."""
        self.acquired += n
        if not self.free():
            self._event.clear()

    async def wait_free(self) -> None:
        """Block until the meter is back under its limit."""
        while not self.free():
            await self._event.wait()

    async def acquire(self, n: int) -> None:
        """Wait for headroom, then book n units."""
        await self.wait_free()
        self.book(n)

    def release(self, n: int) -> None:
        self.acquired -= n
        if self.acquired < 0:
            logger.warning("ResourceLimiter released below zero")
            self.acquired = 0
        if self.free():
            self._event.set()

    def __repr__(self) -> str:
        return f"<ResourceLimiter {self.acquired}/{self.limit}>"


def _nbytes(obj: Any) -> int:
    from distributed_tpu_torch.utils.sizeof import sizeof

    return sizeof(obj)


class ShardsBuffer:
    """Accepts ``{id: [shards]}`` writes, drains them to ``_process``
    through a background flusher, largest bucket first (reference
    shuffle/_buffer.py shape).

    Subclasses implement ``async _process(id, shards)``; the limiter
    budget covers shards accepted but not yet processed.
    """

    def __init__(self, limiter: ResourceLimiter | None = None,
                 concurrency: int = 2):
        self.limiter = limiter or ResourceLimiter(None)
        self.shards: defaultdict[Any, list] = defaultdict(list)
        self.sizes: defaultdict[Any, int] = defaultdict(int)
        self.bytes_total = 0
        self.bytes_written = 0
        self._inflight = 0
        self._wake = asyncio.Event()
        self._done = asyncio.Event()
        self._done.set()
        self._exception: BaseException | None = None
        self.closed = False
        self._tasks = [
            asyncio.create_task(
                self._drain_loop(), name=f"shards-buffer-drain-{i}"
            )
            for i in range(concurrency)
        ]

    async def _process(self, id: Any, shards: list) -> None:
        raise NotImplementedError

    async def write(self, data: dict[Any, list]) -> int:
        """Accept shards; blocks while the limiter is over budget.
        Returns the booked byte estimate (callers reuse it instead of
        re-walking the shard structure)."""
        if self._exception is not None:
            raise self._exception
        if self.closed:
            raise ShuffleClosedError("buffer closed")
        total = 0
        for id, shards in data.items():
            if not shards:
                continue
            n = _nbytes(shards)
            total += n
            self.shards[id].extend(shards)
            self.sizes[id] += n
        if not total:
            return 0
        self.bytes_total += total
        self._done.clear()
        # book BEFORE waking the drainer (its release must never precede
        # the booking), then apply backpressure
        self.limiter.book(total)
        self._wake.set()
        await self.limiter.wait_free()
        # the buffer may have been torn down while we were blocked on
        # backpressure (epoch restart, run TTL): fail rather than report
        # shards accepted that were in fact dropped
        if self._exception is not None:
            raise self._exception
        if self.closed:
            raise ShuffleClosedError("buffer closed while writing")
        return total

    async def _drain_loop(self) -> None:
        while True:
            while not self.shards:
                if self.closed:
                    return
                self._wake.clear()
                if not self.shards and not self._inflight:
                    self._done.set()
                try:
                    await asyncio.wait_for(self._wake.wait(), 0.5)
                except asyncio.TimeoutError:
                    continue
            # largest bucket first keeps spill files chunky
            id = max(self.sizes, key=self.sizes.__getitem__)
            shards = self.shards.pop(id)
            size = self.sizes.pop(id)
            self._inflight += 1
            try:
                await self._process(id, shards)
                self.bytes_written += size
            except Exception as e:  # surfaced on next write/flush
                logger.exception("shard buffer process failed")
                self._exception = e
                self.closed = True
            finally:
                self._inflight -= 1
                self.limiter.release(size)
                if not self.shards and not self._inflight:
                    self._done.set()

    async def flush(self) -> None:
        """Wait until every accepted shard has been processed."""
        self._wake.set()
        await self._done.wait()
        if self._exception is not None:
            raise self._exception
        if self.closed:
            raise ShuffleClosedError("buffer closed")

    async def close(self) -> None:
        self.closed = True
        self._wake.set()
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks = []
        # shards booked but never drained: release their budget so
        # writers blocked on backpressure wake up (and then observe
        # `closed` and raise), and unblock any flush() waiters — without
        # this, a transfer body awaiting wait_free() on a torn-down run
        # sleeps forever, wedging its execution slot (the round-3
        # mid-shuffle worker-loss hang)
        pending = sum(self.sizes.values())
        self.shards.clear()
        self.sizes.clear()
        if pending:
            self.limiter.release(pending)
        self._done.set()


class MemoryShardsBuffer(ShardsBuffer):
    """Keeps everything in memory (small shuffles / tests)
    (reference shuffle/_memory.py)."""

    def __init__(self, limiter: ResourceLimiter | None = None):
        super().__init__(limiter=limiter, concurrency=1)
        self._store: defaultdict[Any, list] = defaultdict(list)

    async def _process(self, id: Any, shards: list) -> None:
        self._store[id].extend(shards)

    async def read(self, id: Any) -> list:
        await self.flush()
        return self._store.pop(id, [])


class DiskShardsBuffer(ShardsBuffer):
    """Append-only spill file per output partition (reference
    shuffle/_disk.py).  Each record is a protocol-5 pickle with its
    out-of-band buffers stored as separate length-prefixed frames —
    ``[u64 n_frames][u64 len]*n [frames...]`` — so array payloads are
    written without being re-copied into the pickle stream and read
    back as zero-copy views of one file blob.  File IO runs in a thread
    so the event loop never blocks on disk."""

    def __init__(self, directory: str,
                 limiter: ResourceLimiter | None = None):
        super().__init__(limiter=limiter, concurrency=2)
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._locks: defaultdict[Any, asyncio.Lock] = defaultdict(asyncio.Lock)

    def _path(self, id: Any) -> str:
        return os.path.join(self.directory, f"{id}.shards")

    async def _process(self, id: Any, shards: list) -> None:
        from distributed_tpu_torch.protocol.serialize import pickle_oob_frames

        pieces: list = []
        for s in shards:
            buffers: list = []
            data = pickle.dumps(s, protocol=5, buffer_callback=buffers.append)
            frames = [data] + pickle_oob_frames(buffers)
            lengths = [memoryview(f).nbytes for f in frames]
            pieces.append(
                struct.pack(f"<{1 + len(frames)}Q", len(frames), *lengths)
            )
            pieces.extend(frames)
        async with self._locks[id]:
            await asyncio.get_running_loop().run_in_executor(
                None, self._append, self._path(id), pieces
            )

    @staticmethod
    def _append(path: str, pieces: list) -> None:
        with open(path, "ab") as f:
            for p in pieces:
                f.write(p)

    async def read(self, id: Any) -> list:
        """All shards spilled for this partition (flushes first)."""
        await self.flush()
        async with self._locks[id]:
            return await asyncio.get_running_loop().run_in_executor(
                None, self._read_sync, self._path(id)
            )

    @staticmethod
    def _read_sync(path: str) -> list:
        if not os.path.exists(path):
            return []
        out = []
        # read into a mutable blob: shards reconstruct as writable views
        # (the in-band pickle path returned writable copies — a consumer
        # mutating a shard in place must not fail only when it spilled)
        size = os.path.getsize(path)
        data = bytearray(size)
        with open(path, "rb") as f:
            n = f.readinto(data)
        if n != size:
            del data[n:]
        mv = memoryview(data)
        off = 0
        while off < len(data):
            (n_frames,) = struct.unpack_from("<Q", data, off)
            off += 8
            lengths = struct.unpack_from(f"<{n_frames}Q", data, off)
            off += 8 * n_frames
            frames = []
            for n in lengths:
                frames.append(mv[off : off + n])
                off += n
            # buffers deserialize as views of the one file blob
            out.append(pickle.loads(frames[0], buffers=frames[1:]))
        return out

    async def close(self) -> None:
        await super().close()
        try:
            for name in os.listdir(self.directory):
                if name.endswith(".shards"):
                    os.unlink(os.path.join(self.directory, name))
            os.rmdir(self.directory)
        except OSError:
            pass


class CommShardsBuffer(ShardsBuffer):
    """Batches outbound shards per destination worker and pushes them
    with a caller-provided async send (reference shuffle/_comms.py).

    ``message_bytes_limit`` (config ``shuffle.comm-message-bytes``) caps a
    single RPC message: a backed-up bucket is split into several sends
    rather than serialized as one giant message (reference _comms.py
    message-bytes-limit semantics)."""

    def __init__(
        self,
        send: Callable[[str, list], Awaitable[None]],
        limiter: ResourceLimiter | None = None,
        concurrency: int = 4,
        message_bytes_limit: int | None = None,
    ):
        super().__init__(limiter=limiter, concurrency=concurrency)
        self._send = send
        self.message_bytes_limit = message_bytes_limit

    async def _process(self, id: Any, shards: list) -> None:
        limit = self.message_bytes_limit
        if not limit or len(shards) <= 1:
            await self._send(id, shards)
            return
        batch: list = []
        batch_bytes = 0
        for shard in shards:
            n = _nbytes(shard)
            if batch and batch_bytes + n > limit:
                await self._send(id, batch)
                batch = []
                batch_bytes = 0
            batch.append(shard)
            batch_bytes += n
        if batch:
            await self._send(id, batch)
