"""Wire data-plane instrumentation + pooled receive buffers.

The zero-copy contract (docs/wire.md): the send side hands ``dumps``
frames to the transport as memoryviews with no per-frame ``bytes()``
materialization, and the receive side reads a whole message into ONE
contiguous buffer and carves frames as read-only memoryview slices.
This module holds the two pieces both comm backends and the protocol
layer share:

- :data:`WIRE` — process-global counters for bytes moved, payload
  copies (any materialization of a payload-sized frame; the send path
  must record **zero**), pool traffic and compression volume.  Exported
  at ``/metrics`` as ``dtpu_wire_*`` (http/server.py) and asserted by
  tests and the smoke bench.
- :class:`BufferPool` / :func:`recv_pool` — bounded pool of receive
  buffers keyed by power-of-two size class, with exact one-shot
  allocation for giants.  Ownership rule: a buffer goes back to the
  pool only when nothing else holds a view of it — ``release`` probes
  for live exports (resizing a bytearray with exported views raises
  ``BufferError``) and simply drops still-referenced buffers, so a
  deserialized numpy array may keep its zero-copy view of the message
  buffer indefinitely; the pool never reuses memory out from under it.
"""

from __future__ import annotations

import threading

from distributed_tpu_torch import config


class WireCounters:
    """Monotonic counters for the wire data plane (one set per process)."""

    __slots__ = (
        "bytes_sent",
        "bytes_recv",
        "payload_copies",
        "pool_hits",
        "pool_misses",
        "pool_drops",
        "compress_bytes_in",
        "compress_bytes_out",
        "decompress_bytes_in",
    )

    def __init__(self) -> None:
        for name in self.__slots__:
            setattr(self, name, 0)

    def snapshot(self) -> dict[str, int]:
        return {name: getattr(self, name) for name in self.__slots__}


#: process-global wire counters (metrics read these; tests diff snapshots)
WIRE = WireCounters()


class BufferPool:
    """Bounded receive-buffer pool keyed by power-of-two size class.

    ``acquire(n)`` returns a bytearray of the smallest pooled class that
    fits ``n`` (callers slice ``memoryview(buf)[:n]``); requests above
    ``MAX_CLASS`` get an exact, never-pooled allocation.  ``release``
    returns a buffer to the free list unless something still exports a
    view of it (see the ownership rule in the module docstring) or the
    pool is at its byte budget — either way the buffer is dropped to the
    garbage collector, never invalidated.
    """

    #: pooled size classes.  The pool earns its keep on the control
    #: plane (small, fully-deserialized messages whose buffers actually
    #: come back); big data messages pin zero-copy views and drop their
    #: buffers anyway, so giants get EXACT one-shot numpy allocations —
    #: ``np.empty`` skips the memset a rounded-up bytearray would pay
    #: (an 8 MB payload in a zeroed 16 MiB bytearray cost ~40% of the
    #: large-frame throughput in the A/B)
    MIN_CLASS = 12  # 4 KiB — smaller requests round up to this
    MAX_CLASS = 20  # 1 MiB — larger requests bypass the pool

    def __init__(self, max_bytes: int) -> None:
        self.max_bytes = max_bytes
        self._free: dict[int, list[bytearray]] = {}
        self._pooled_bytes = 0
        # comms may live on several loops in one process (sync Client
        # thread + LocalCluster loops); pool ops are lock-guarded
        self._lock = threading.Lock()

    @property
    def pooled_bytes(self) -> int:
        return self._pooled_bytes

    def acquire(self, nbytes: int):
        if nbytes > (1 << self.MAX_CLASS):
            import numpy as np

            WIRE.pool_misses += 1
            return np.empty(nbytes, np.uint8)
        cls = max((max(nbytes, 1) - 1).bit_length(), self.MIN_CLASS)
        with self._lock:
            free = self._free.get(cls)
            if free:
                buf = free.pop()
                self._pooled_bytes -= len(buf)
                WIRE.pool_hits += 1
                return buf
        WIRE.pool_misses += 1
        return bytearray(1 << cls)

    def release(self, buf) -> None:
        if not isinstance(buf, bytearray):
            return  # exact giant alloc: the GC owns it
        n = len(buf)
        if (
            n & (n - 1)  # not a pool class size
            or not (1 << self.MIN_CLASS) <= n <= (1 << self.MAX_CLASS)
        ):
            return
        try:
            # export probe: a resize on a bytearray with live exported
            # views raises BufferError without touching the data — if
            # anything (a numpy array, a Serialized frame) still views
            # this buffer, it keeps the memory and the pool forgets it
            buf.append(0)
            del buf[-1:]
        except BufferError:
            WIRE.pool_drops += 1
            return
        with self._lock:
            if self._pooled_bytes + n > self.max_bytes:
                WIRE.pool_drops += 1
                return
            self._free.setdefault(n.bit_length() - 1, []).append(buf)
            self._pooled_bytes += n


_recv_pool: BufferPool | None = None
_recv_pool_lock = threading.Lock()


def recv_pool() -> BufferPool:
    """The process-wide receive pool (sized by ``comm.receive-pool-bytes``
    at first use)."""
    global _recv_pool
    if _recv_pool is None:
        with _recv_pool_lock:
            if _recv_pool is None:
                _recv_pool = BufferPool(
                    config.parse_bytes(config.get("comm.receive-pool-bytes"))
                )
    return _recv_pool


_mmb_memo: tuple = (None, 0)


def max_message_bytes() -> int:
    """Upper bound on one wire message (``comm.max-message-bytes``): a
    corrupt or hostile frame-lengths header must not trigger an
    arbitrary-size allocation.  Called once per message on the read hot
    path, so the parsed value is memoized on the raw config object —
    runtime overrides (``config.set``) swap the object and re-parse."""
    global _mmb_memo
    raw = config.get("comm.max-message-bytes")
    memo = _mmb_memo
    if raw is not memo[0]:
        memo = (raw, config.parse_bytes(raw))
        _mmb_memo = memo
    return memo[1]
