"""Frame protocol: message <-> list of frames, without msgpack.

The port's copy of ``distributed_tpu/protocol/core.py``.  The frames are
the reference's:

    frames[0]  header: {"compression": [...], "lengths": [...],
                        "sub-headers": [subheader, ...]}
    frames[1]  body: the message with Serialize/ToPickle leaves replaced
               by placeholder markers
    frames[2:] out-of-band payload frames for each serialized leaf,
               possibly compressed, big ones split at ``comm.shard``

and so are the placeholders, the shards, the sub-headers and the
compression.  The seam is the encoding of the header and the body: the
reference packs both with msgpack (``:25,126-127,237-238``), which the
card's machine does not have; the port encodes them with the standard
library's ``marshal``.

marshal writes only exact built-in types and refuses subclasses
(``IntEnum`` raises ``ValueError``), where msgpack with
``strict_types=False`` packs a subclass as its base type.  So the walk
that ``_extract`` already makes over the whole message also normalises,
as msgpack's round trip would:

- tuple -> list, and a ``dict`` or ``list`` subclass -> the plain type;
- ``bytearray`` and ``memoryview`` -> ``bytes``;
- a ``str`` / ``int`` / ``float`` / ``bytes`` subclass -> the exact base
  type, in values and in keys;
- a set or frozenset -> a set of its normalised elements (the reference's
  ``__dtpu_set__`` round trip gives a set), and a dict whose one key is
  ``"__dtpu_set__"`` -> the set the reference's decode makes of it.

The walk refuses what the reference's msgpack refuses, with its exception
type: another object, and an int outside [-2^63, 2^64), raise
``TypeError`` (msgpack hands both to the reference's ``default`` hook,
which raises it), and a container where a key or a set element is wanted
raises ``TypeError`` (the reference's decode fails there on an unhashable
list).  One difference stays: a ``str`` holding a lone surrogate passes
here, where msgpack raises ``UnicodeEncodeError``.

marshal's format depends on the interpreter, and malformed input can
crash it.  So the header frame starts with :data:`PREFIX`, a fixed magic,
``marshal.version`` and the Python minor version, and :func:`loads`
raises :class:`~distributed_tpu_torch.exceptions.ProtocolError` on any
mismatch before it calls ``marshal.loads``: peers must run the same
Python minor version.  The envelope pickles nothing, as the reference's
does not: a message from an untrusted peer can be inspected before any
unpickling happens.
"""

from __future__ import annotations

import marshal
import sys
from typing import Any

from distributed_tpu_torch import config
from distributed_tpu_torch.exceptions import ProtocolError
from distributed_tpu_torch.protocol import pickle as _pickle
from distributed_tpu_torch.protocol.buffers import WIRE
from distributed_tpu_torch.protocol.compression import (
    decompress_frame,
    get_default_compression,
    maybe_compress,
)
from distributed_tpu_torch.protocol.serialize import (
    Pickled,
    Serialize,
    Serialized,
    ToPickle,
    deserialize,
    pickle_oob_frames,
    serialize,
)

_PLACEHOLDER = "__dtpu_ser__"  # marker in the body
_PICKLE_PLACEHOLDER = "__dtpu_pkl__"
_SET = "__dtpu_set__"  # the reference's set marker, read as its decode reads it

MAGIC = b"DTPUWIRE"
# graft-lint: allow[wire-no-copy] the 12-byte header prefix, built once at import; not a payload frame
PREFIX = MAGIC + bytes((marshal.version, sys.version_info[0], sys.version_info[1]))

_INT_MIN = -(1 << 63)
_INT_END = 1 << 64


def _shard_size() -> int:
    return config.parse_bytes(config.get("comm.shard"))


def _atom(obj: Any) -> Any:
    """A leaf as msgpack would round-trip it: the exact base type, or the
    exception msgpack raises."""
    typ = type(obj)
    if typ is int:
        if _INT_MIN <= obj < _INT_END:
            return obj
        raise TypeError(f"cannot msgpack {typ!r}")
    if typ is str or typ is float or typ is bool or typ is bytes or obj is None:
        return obj
    if isinstance(obj, int):  # IntEnum and other subclasses (bool is final)
        return _atom(int(obj))
    if isinstance(obj, str):
        return str.__str__(obj)
    if isinstance(obj, float):
        return float(obj)
    if isinstance(obj, (bytes, bytearray, memoryview)):
        # graft-lint: allow[wire-no-copy] envelope value, not a payload frame
        return bytes(obj)
    raise TypeError(f"cannot msgpack {typ!r}")


def _key(obj: Any) -> Any:
    """A dict key or set element: an atom; a container is unhashable after
    the reference's decode."""
    if isinstance(obj, (tuple, list, dict, set, frozenset)):
        raise TypeError(f"unhashable type: {'dict' if isinstance(obj, dict) else 'list'!r}")
    return _atom(obj)


def _extract(obj: Any, path: tuple, out: dict[tuple, Any]) -> Any:
    """Replace serializable leaves with placeholders, collecting them, and
    normalise every other value to what marshal writes."""
    typ = type(obj)
    if typ is str or typ is float or typ is bool or typ is bytes or obj is None:
        return obj
    if typ is int:
        if _INT_MIN <= obj < _INT_END:
            return obj
        raise TypeError(f"cannot msgpack {typ!r}")
    if isinstance(obj, (Serialize, Serialized)):
        out[path] = obj
        return {_PLACEHOLDER: list(path)}
    if isinstance(obj, (ToPickle, Pickled)):
        out[path] = obj
        return {_PICKLE_PLACEHOLDER: list(path)}
    if isinstance(obj, dict):
        if len(obj) == 1 and _SET in obj:
            return _as_set(obj[_SET])
        res = {}
        for k, v in obj.items():
            k = _key(k)
            res[k] = _extract(v, path + (k,), out)
        return res
    if isinstance(obj, (list, tuple)):
        return [_extract(v, path + (i,), out) for i, v in enumerate(obj)]
    if isinstance(obj, (set, frozenset)):
        return _as_set(obj)
    return _atom(obj)


def _as_set(items: Any) -> set:
    return {_key(v) for v in items}


def dumps(msg: Any, *, compression: str | None = "auto") -> list[bytes | memoryview]:
    """Serialize a message to a list of frames."""
    if compression == "auto":
        compression = get_default_compression() if config.get("comm.compression") else None

    extracted: dict[tuple, Any] = {}
    skeleton = _extract(msg, (), extracted)

    sub_headers: list[dict] = []
    payload_frames: list[Any] = []
    frame_compression: list[str | None] = []
    frame_lengths: list[int] = []
    shard = _shard_size()

    for path, leaf in extracted.items():
        if isinstance(leaf, (Serialize, Serialized)):
            head, frames = serialize(leaf)
        elif isinstance(leaf, Pickled):
            head, frames = leaf.header, leaf.frames
        else:  # ToPickle
            buffers: list = []
            data = _pickle.dumps(leaf.data, buffer_callback=buffers.append)
            head = {"serializer": "pickle", "num-buffers": len(buffers)}
            frames = [data] + pickle_oob_frames(buffers)
        # COPY before annotating: a Serialized leaf hands back its OWN
        # header dict, and one object can appear at many paths (e.g. a
        # single erred exception blamed on 16 dependents in one report
        # batch).  Mutating the shared dict made every sub-header carry
        # the LAST path — 15 of the 16 placeholders had no frames and
        # the receiving comm died on KeyError — and corrupted the
        # stored Serialized for every later forward.
        head = _extract(head, (), {})  # a family's header holds no payload leaf
        # split big frames so no single read/write exceeds the shard size
        split_frames: list = []
        split_sizes: list[int] = []
        uncompressed = 0
        for f in frames:
            if isinstance(f, bytes):
                mv = f
                n = len(f)
            else:
                mv = memoryview(f)
                if mv.format != "B" or mv.ndim != 1:
                    mv = mv.cast("B")
                n = mv.nbytes
            uncompressed += n
            if n > shard:
                # shard boundaries live in the header ("splits"); the
                # parts are zero-copy views — bytes frames too (slicing
                # bytes directly would materialize a copy per shard)
                if isinstance(mv, bytes):
                    mv = memoryview(mv)
                parts = [mv[i : i + shard] for i in range(0, n, shard)]
            else:
                parts = [mv]
            split_frames.extend(parts)
            split_sizes.append(len(parts))
        # true payload size BEFORE compression: opaque store-and-forward
        # servers account nbytes from this, not from (possibly
        # compressed) wire frames, so spill/rebalance see memory truth
        head.setdefault("nbytes", uncompressed)
        head["path"] = list(path)
        head["frame-start"] = len(payload_frames)
        head["splits"] = split_sizes
        sub_headers.append(head)
        for f in split_frames:
            codec, data = maybe_compress(f, compression)
            payload_frames.append(data)
            frame_compression.append(codec)
            frame_lengths.append(memoryview(data).nbytes)

    header = {
        "compression": frame_compression,
        "lengths": frame_lengths,
        "sub-headers": sub_headers,
    }
    body = marshal.dumps(skeleton)
    head_frame = PREFIX + marshal.dumps(header)
    return [head_frame, body] + payload_frames


def _buffer_address(view: memoryview) -> int:
    import numpy as np

    return np.frombuffer(view, np.uint8).__array_interface__["data"][0]


def _merge_parts(parts: list) -> Any:
    """Reassemble one sharded frame from its split parts.

    Fast path: when every part is an uncompressed memoryview slice of
    the SAME backing buffer and the slices are adjacent — the common
    case, because the receive side reads the whole message into one
    contiguous buffer and dumps shards frames in order — the merge is a
    single zero-copy slice of that buffer.  Otherwise (some shards were
    compressed, or arrived in separate buffers) the parts gather into
    ONE preallocated bytearray: one copy total, never bytes()-per-part.
    """
    base = parts[0].obj if isinstance(parts[0], memoryview) else None
    if base is not None and all(
        isinstance(p, memoryview)
        and p.obj is base
        and p.contiguous
        and p.format == "B"
        and p.ndim == 1
        and p.nbytes
        for p in parts
    ):
        try:
            start = _buffer_address(parts[0]) - _buffer_address(
                memoryview(base)
            )
            expect = _buffer_address(parts[0])
            adjacent = True
            for p in parts:
                if _buffer_address(p) != expect:
                    adjacent = False
                    break
                expect += p.nbytes
            if adjacent:
                total = sum(p.nbytes for p in parts)
                merged = memoryview(base)[start : start + total]
                if merged.nbytes == total:
                    return merged.toreadonly()
        except (TypeError, ValueError, BufferError):
            pass  # exotic exporter: fall through to the gather
    WIRE.payload_copies += 1
    out = bytearray(sum(memoryview(p).nbytes for p in parts))
    pos = 0
    for p in parts:
        n = memoryview(p).nbytes
        out[pos : pos + n] = p
        pos += n
    return memoryview(out).toreadonly()


def _plant(obj: Any, values: dict[tuple, Any]) -> Any:
    if isinstance(obj, dict):
        if _PLACEHOLDER in obj and len(obj) == 1:
            return values[tuple(obj[_PLACEHOLDER])]
        if _PICKLE_PLACEHOLDER in obj and len(obj) == 1:
            return values[tuple(obj[_PICKLE_PLACEHOLDER])]
        return {k: _plant(v, values) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_plant(v, values) for v in obj]
    return obj


def read_header(frame: Any) -> dict:
    """The header of ``frame``, checked for :data:`PREFIX` before
    ``marshal`` reads a byte of it."""
    view = memoryview(frame).cast("B")
    n = len(PREFIX)
    # graft-lint: allow[wire-no-copy] the 12-byte header prefix, compared and dropped; not a payload frame
    got = bytes(view[:n])
    if got != PREFIX:
        if got[: len(MAGIC)] != MAGIC:
            raise ProtocolError("not a frame of this wire: the header lacks its magic")
        raise ProtocolError(
            f"a peer wrote marshal format {got[len(MAGIC)]} on Python "
            f"{got[len(MAGIC) + 1]}.{got[len(MAGIC) + 2]}; this process reads format "
            f"{marshal.version} on Python {sys.version_info[0]}.{sys.version_info[1]}"
        )
    try:
        header = marshal.loads(view[n:])
    except (ValueError, EOFError, TypeError) as exc:
        raise ProtocolError(f"a malformed header: {exc}") from exc
    if not isinstance(header, dict):
        raise ProtocolError(f"a header of type {type(header).__name__}, not a dict")
    return header


def loads(frames: list, *, deserializers: bool = True) -> Any:
    """Reconstruct a message from frames.

    ``deserializers=False`` leaves ``Serialize`` leaves wrapped as
    ``Serialized`` (store-and-forward without decode, reference
    ``deserialize=False`` path)."""
    header = read_header(frames[0])
    try:
        body = marshal.loads(frames[1])
    except (ValueError, EOFError, TypeError) as exc:
        raise ProtocolError(f"a malformed body: {exc}") from exc
    payload = frames[2:]

    compression = header.get("compression", [])
    values: dict[tuple, Any] = {}
    for sub in header.get("sub-headers", []):
        start = sub["frame-start"]
        splits = sub["splits"]
        # reassemble split frames, decompressing each part
        leaf_frames: list = []
        idx = start
        for nparts in splits:
            parts = []
            for _ in range(nparts):
                f = decompress_frame(payload[idx], compression[idx] if idx < len(compression) else None)
                parts.append(f)
                idx += 1
            if len(parts) == 1:
                leaf_frames.append(parts[0])
            else:
                leaf_frames.append(_merge_parts(parts))
        path = tuple(sub["path"])
        sub2 = {k: v for k, v in sub.items() if k not in ("path", "frame-start", "splits")}
        if deserializers:
            values[path] = deserialize(sub2, leaf_frames)
        else:
            values[path] = Serialized(sub2, leaf_frames)
    return _plant(body, values)
