"""BatchedSend: coalesce many tiny messages onto one comm.

Reference batched.py:20 — the scheduler<->worker and scheduler<->client
event streams each push hundreds of tiny dicts per second; sending each in
its own write would syscall-storm.  ``send()`` appends to a buffer; a
background loop flushes the whole buffer as one list the moment it wakes.
Coalescing comes from messages accumulating while the previous
``comm.write`` awaits — there is deliberately NO timed window: any sleep
here sits inside every scheduler<->worker round trip.
"""

from __future__ import annotations

import asyncio
import logging
from collections import deque
from typing import Any

from distributed_tpu_torch.comm.core import Comm
from distributed_tpu_torch.exceptions import CommClosedError

logger = logging.getLogger("distributed_tpu_torch.rpc")


class BatchedSend:
    def __init__(self):
        self.buffer: deque = deque()
        self.comm: Comm | None = None
        self.please_stop = False
        self.waker = asyncio.Event()
        self.stopped = asyncio.Event()
        self.stopped.set()
        self._background_task: asyncio.Task | None = None
        self.byte_count = 0
        self.batch_count = 0

    def start(self, comm: Comm) -> None:
        if self._background_task is not None and not self._background_task.done():
            raise RuntimeError("BatchedSend already running")
        self.comm = comm
        self.please_stop = False
        self.stopped.clear()
        self.waker.set()
        self._background_task = asyncio.create_task(self._background_send())

    def closed(self) -> bool:
        return self.comm is None or self.comm.closed

    def send(self, *msgs: Any) -> None:
        """Enqueue; raises if the stream was closed."""
        if self.comm is not None and self.comm.closed:
            raise CommClosedError(f"comm {self.comm!r} already closed")
        self.buffer.extend(msgs)
        self.waker.set()

    async def _background_send(self) -> None:
        # idle streams block on the waker with NO timer (the pre-r4
        # wait_for(..., interval) tick created a Task + timeout context +
        # heap timer per stream per 2 ms even with nothing to send), and
        # a ready message flushes IMMEDIATELY — any sleep in this loop
        # (before or after the flush) inserts its full length into every
        # scheduler<->worker request-response round trip and stalls the
        # whole pipeline (measured: a trailing interval-sleep cost
        # +66 us/task; a leading one +400).  Coalescing still happens:
        # messages arriving while comm.write awaits accumulate in the
        # buffer and go out as one list on the next iteration.
        try:
            while not self.please_stop:
                await self.waker.wait()
                self.waker.clear()
                if not self.buffer:
                    if self.please_stop:
                        break
                    continue
                payload, self.buffer = list(self.buffer), deque()
                try:
                    nbytes = await self.comm.write(payload)
                    self.byte_count += nbytes
                    self.batch_count += 1
                except CommClosedError:
                    # retain the payload for a possible restart on a new comm
                    payload.extend(self.buffer)
                    self.buffer = deque(payload)
                    break
        finally:
            self.stopped.set()

    async def close(self, timeout: float | None = None) -> None:
        """Flush and close the comm."""
        self.please_stop = True
        self.waker.set()
        if self._background_task is not None:
            try:
                await asyncio.wait_for(self.stopped.wait(), timeout)
            except asyncio.TimeoutError:
                self._background_task.cancel()
        if self.comm is not None and not self.comm.closed:
            try:
                if self.buffer:
                    payload, self.buffer = list(self.buffer), deque()
                    await self.comm.write(payload)
            except CommClosedError:
                pass
            await self.comm.close()

    def abort(self) -> None:
        self.please_stop = True
        self.buffer.clear()
        self.waker.set()
        if self.comm is not None and not self.comm.closed:
            self.comm.abort()

    def __repr__(self) -> str:
        n = len(self.buffer)
        state = "closed" if self.closed() else "open"
        return f"<BatchedSend {state}: {n} buffered>"
