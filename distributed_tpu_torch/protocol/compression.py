"""Per-frame compression registry with sampling-based auto decision.

Equivalent of the reference's ``distributed/protocol/compression.py``: a
registry of (compress, decompress) pairs, negotiated per-connection at
handshake; ``maybe_compress`` samples 10 kB of a large frame and only
compresses the whole frame if the sample shrinks below 90% — so
incompressible data (already-compressed, random, packed floats) never pays
the CPU cost.

Available codecs here: zstd (C, baked in), zlib (stdlib).  lz4/snappy are
not in this image and are simply absent from the registry.
"""

from __future__ import annotations

import zlib
from collections.abc import Callable
from typing import Any

from distributed_tpu_torch import config
from distributed_tpu_torch.protocol.buffers import WIRE


class Compression:
    __slots__ = ("name", "compress", "decompress")

    def __init__(self, name: str, compress: Callable, decompress: Callable):
        self.name = name
        self.compress = compress
        self.decompress = decompress


compressions: dict[str, Compression] = {
    "zlib": Compression("zlib", zlib.compress, zlib.decompress),
}

try:
    import zstandard

    _zstd_c = zstandard.ZstdCompressor(
        level=config.get("comm.zstd.level", 3),
        threads=config.get("comm.zstd.threads", 0),
    )
    _zstd_d = zstandard.ZstdDecompressor()

    def _zstd_compress(data) -> bytes:
        # zstandard takes any buffer-protocol object directly: no
        # intermediate bytes() copy of the frame
        return _zstd_c.compress(data)

    def _zstd_decompress(data) -> bytes:
        return _zstd_d.decompress(data)

    compressions["zstd"] = Compression("zstd", _zstd_compress, _zstd_decompress)
    DEFAULT = "zstd"
except ImportError:  # pragma: no cover
    DEFAULT = "zlib"


def get_default_compression() -> str | None:
    c = config.get("comm.compression", "auto")
    if c == "auto":
        return DEFAULT
    if c in (None, False, "none", "None"):
        return None
    if c in compressions:
        return c
    raise ValueError(f"unknown compression {c!r}; available: {list(compressions)}")


# Sampling thresholds (reference compression.py:159-200 semantics)
MIN_SIZE = 10_000  # don't bother below 10 kB
SAMPLE_SIZE = 10_000
N_SAMPLES = 5


def maybe_compress(
    payload: bytes | memoryview,
    compression: str | None,
) -> tuple[str | None, bytes | memoryview]:
    """Maybe compress ``payload``; returns (codec-name-or-None, data)."""
    if not compression or compression not in compressions:
        return None, payload
    nbytes = memoryview(payload).nbytes
    if nbytes < MIN_SIZE:
        return None, payload
    comp = compressions[compression]
    mv = payload if isinstance(payload, memoryview) else memoryview(payload)
    if mv.format != "B" or mv.ndim != 1:
        mv = mv.cast("B")
    if nbytes >= N_SAMPLES * SAMPLE_SIZE:
        # sample N stripes straight off the buffer (no gather copy);
        # each stripe compresses separately — per-stripe codec headers
        # are noise against the 10 kB stripes
        stride = nbytes // N_SAMPLES
        sampled_in = sampled_out = 0
        for i in range(N_SAMPLES):
            stripe = mv[i * stride : i * stride + SAMPLE_SIZE]
            sampled_in += stripe.nbytes
            sampled_out += len(comp.compress(stripe))
        if sampled_out > 0.9 * sampled_in:
            return None, payload
    compressed = comp.compress(mv)
    if len(compressed) > 0.9 * nbytes:
        return None, payload
    WIRE.compress_bytes_in += nbytes
    WIRE.compress_bytes_out += len(compressed)
    return compression, compressed


def decompress_frame(frame: Any, compression: str | None) -> Any:
    if not compression:
        return frame
    WIRE.decompress_bytes_in += memoryview(frame).nbytes
    return compressions[compression].decompress(frame)
