"""Serializer family registry: msg -> (header, frames).

The port's copy of ``distributed_tpu/protocol/serialize.py``, line for
line but for these seams:

- **The ``"torch"`` family is the port's own**, registered as a native
  family: :func:`torch_dumps` / :func:`torch_loads` in place of the
  reference's ``_torch_dumps`` / ``_torch_loads`` (``:277-302``).  The
  reference's family records no device and loads every tensor on the CPU;
  this one keeps the reference's wire and adds the device:

  - a CPU tensor gives the reference's header and frame bytes exactly,
    and loads as the reference loads it, so a peer that runs only the
    reference's family interoperates;
  - a CUDA tensor pays one device-to-host copy, as the reference's
    ``jax`` family pays for an accelerator array (``:236-266``), and its
    header also records ``"device": "cuda"``, as the jax family records
    ``platform``.  :func:`torch_loads` puts it on the receiver's current
    CUDA device (``resolve_device(None)``), and raises on a receiver with
    no card: it never keeps a CPU tensor where a CUDA one was sent;
  - a dtype numpy cannot hold (bfloat16) raises in :func:`torch_dumps`,
    as the reference's families raise, so :func:`serialize` takes its
    pickle fallback (``:398-405``).

- **No ``jax`` family** (``:269``): the port imports no jax, and
  ``_family_for`` has no jax branch.
- **Counts.** :func:`serialize` and :func:`deserialize` count, per
  family, the calls and the frame bytes they carried
  (:func:`family_counts`, :func:`reset_family_counts`), so a run can show
  that its wire carried tensors.  Over inproc a payload passes as the
  object itself and no family is called.

:func:`install_serialization` registers the torch family over ``"torch"``
on a REFERENCE cluster through its ``register_serialization_family``,
passed in; the reference already sends every dense tensor to that family
(``_family_for``, ``:371-375``).
"""

from __future__ import annotations

import threading
from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from distributed_tpu_torch._device import resolve_device
from distributed_tpu_torch._install import Installed, install
from distributed_tpu_torch.protocol import pickle as _pickle

# --------------------------------------------------------------- wrappers


class Serialize:
    """Mark ``data`` for serialization when the message is dumped."""

    __slots__ = ("data",)

    def __init__(self, data: Any):
        self.data = data

    def __repr__(self) -> str:
        return f"<Serialize: {self.data!r}>"

    def __eq__(self, other):
        return isinstance(other, Serialize) and other.data == self.data

    def __hash__(self):
        return hash(("Serialize", id(self.data)))


to_serialize = Serialize


class Serialized:
    """Already-serialized payload: forwarded without deserializing."""

    __slots__ = ("header", "frames")

    def __init__(self, header: dict, frames: list):
        self.header = header
        self.frames = frames

    def deserialize(self) -> Any:
        return deserialize(self.header, self.frames)

    def __eq__(self, other):
        return (
            isinstance(other, Serialized)
            and other.header == self.header
            and other.frames == self.frames
        )


class ToPickle:
    """Force pickle serialization through the msgpack channel."""

    __slots__ = ("data",)

    def __init__(self, data: Any):
        self.data = data

    def __repr__(self) -> str:
        return f"<ToPickle: {self.data!r}>"


class Pickled:
    """Already-pickled payload."""

    __slots__ = ("header", "frames")

    def __init__(self, header: dict, frames: list):
        self.header = header
        self.frames = frames


OPAQUE_TYPES = (Serialize, Serialized, ToPickle, Pickled)


def wrap_opaque(obj: Any) -> Any:
    """Prepare a possibly-already-wrapped payload for forwarding.

    Opaque wrappers (how payloads look on a deserialize=False server)
    pass through untouched — re-wrapping would deliver the wrapper
    object itself to the peer.  Raw values are wrapped so they cross
    tcp pickled.  None stays None."""
    if obj is None or isinstance(obj, OPAQUE_TYPES):
        return obj
    return ToPickle(obj)


def compact_frames(obj: Any) -> Any:
    """Copy view-backed frames of a LONG-LIVED opaque wrapper into owned
    bytes (docs/wire.md ownership rule: holders that outlive the message
    must copy).  A ``Serialized`` run_spec on a deserialize=False server
    is a small slice of the message's whole pooled receive buffer; kept
    as a view for the task's lifetime it would pin that entire buffer —
    a ~100-byte spec holding megabytes.  One exact-size copy at store
    time restores the pre-zero-copy memory profile for stores while the
    forwarding path stays copy-free.  Pass-through for non-wrappers."""
    if isinstance(obj, (Serialized, Pickled)):
        obj.frames = [
            # graft-lint: allow[wire-no-copy] long-lived store: the copy releases the pinned receive buffer
            bytes(f) if isinstance(f, memoryview) else f
            for f in obj.frames
        ]
    return obj


def payload_nbytes(obj: Any) -> int:
    """Size estimate for accounting without deserializing: the dumps-time
    uncompressed size when the header recorded one (protocol/core.py),
    frame bytes otherwise, sizeof for live objects."""
    if isinstance(obj, (Serialized, Pickled)):
        n = obj.header.get("nbytes") if isinstance(obj.header, dict) else None
        if n:
            return int(n)
        return sum(
            len(f) if isinstance(f, (bytes, bytearray)) else f.nbytes
            for f in obj.frames
        )
    if isinstance(obj, (Serialize, ToPickle)):
        obj = obj.data
    from distributed_tpu_torch.utils.sizeof import sizeof

    return sizeof(obj)


def unwrap(obj: Any) -> Any:
    """Undo protocol wrappers that survive an in-process hop.

    Over tcp the comm layer serializes ``Serialize``/``ToPickle`` leaves and
    the reader gets plain values; over inproc the wrapper object itself
    arrives.  Consumption points call this to accept both.
    """
    if isinstance(obj, (Serialize, ToPickle)):
        return obj.data
    if isinstance(obj, (Serialized, Pickled)):
        return deserialize(obj.header, obj.frames)
    return obj


# ----------------------------------------------------- family registry

families: dict[str, tuple[Callable, Callable]] = {}


def register_serialization_family(name: str, dumps: Callable, loads: Callable) -> None:
    """Register ``dumps(x) -> (header, frames)`` / ``loads(header, frames) -> x``
    (reference serialize.py:191)."""
    families[name] = (dumps, loads)


def pickle_oob_frames(buffers: list) -> list:
    """Protocol-5 out-of-band buffers as wire frames, zero-copy: a
    ``PickleBuffer``'s ``raw()`` view shares the producer's memory (and
    keeps it alive).  Non-contiguous exporters — which ``raw()`` refuses
    — are materialized once."""
    frames = []
    for b in buffers:
        if isinstance(b, (bytes, memoryview)):
            frames.append(b)
            continue
        try:
            frames.append(b.raw())
        except (AttributeError, BufferError):
            # graft-lint: allow[wire-no-copy] non-contiguous pickle buffer: a flat copy is the only way onto the wire
            frames.append(bytes(b))
    return frames


def _pickle_dumps(x: Any) -> tuple[dict, list]:
    buffers: list = []
    data = _pickle.dumps(x, buffer_callback=buffers.append)
    frames = [data] + pickle_oob_frames(buffers)
    return {"serializer": "pickle", "num-buffers": len(buffers)}, frames


def _pickle_loads(header: dict, frames: list) -> Any:
    # pickle.loads takes any bytes-like pickle stream; frames stay views
    return _pickle.loads(frames[0], buffers=frames[1:])


register_serialization_family("pickle", _pickle_dumps, _pickle_loads)


def _numpy_dumps(x) -> tuple[dict, list]:
    import numpy as np

    x = np.ascontiguousarray(x)
    header = {
        "serializer": "numpy",
        "dtype": x.dtype.str,
        "shape": list(x.shape),
    }
    return header, [x.data.cast("B")]


def _numpy_loads(header: dict, frames: list):
    import numpy as np

    buf = frames[0]
    arr = np.frombuffer(buf, dtype=np.dtype(header["dtype"]))
    return arr.reshape(header["shape"])


register_serialization_family("numpy", _numpy_dumps, _numpy_loads)


def torch_dumps(x: torch.Tensor) -> tuple[dict, list]:
    """``(header, frames)`` of a CPU or CUDA tensor.  Raises ``TypeError``
    for a dtype numpy cannot hold, before any copy."""
    t = x.detach()
    device = t.device.type
    if device not in ("cpu", "cuda"):
        raise ValueError(f"torch_dumps: tensors on {t.device} have no wire")
    if device == "cuda":
        torch.empty(0, dtype=t.dtype).numpy()  # the dtype check, before the copy
        t = t.contiguous().cpu()  # the one device-to-host copy
    elif not t.is_contiguous():
        t = t.contiguous()
    header, frames = _numpy_dumps(t.numpy())
    header["serializer"] = "torch"
    header["requires_grad"] = bool(x.requires_grad)
    if device == "cuda":
        header["device"] = "cuda"
    return header, frames


def torch_loads(header: dict, frames: list) -> torch.Tensor:
    """The tensor of ``(header, frames)``: on the CPU, owning its memory
    (frames may be mapped), or on this process's current CUDA device,
    which raises where there is none."""
    arr = _numpy_loads(header, frames)
    device = header.get("device", "cpu")
    if device == "cpu":
        t = torch.from_numpy(arr.copy())
    elif device == "cuda":
        dev = resolve_device(None)
        host = arr if arr.flags.writeable else arr.copy()
        t = torch.from_numpy(host).to(dev)  # the one host-to-device copy
    else:
        raise ValueError(f"torch_loads: unknown device {device!r}")
    if header.get("requires_grad"):
        t.requires_grad_(True)
    return t


register_serialization_family("torch", torch_dumps, torch_loads)


def _arrow_dumps(x) -> tuple[dict, list]:
    """Arrow Tables / RecordBatches via the IPC stream format (reference
    protocol/arrow.py): schema-preserving, zero-copy on load."""
    import pyarrow as pa

    sink = pa.BufferOutputStream()
    kind = "table" if isinstance(x, pa.Table) else "batch"
    with pa.ipc.new_stream(sink, x.schema) as writer:
        if kind == "table":
            for batch in x.to_batches():
                writer.write_batch(batch)
        else:
            writer.write_batch(x)
    # memoryview: the frame contract is bytes/memoryview (payload_nbytes,
    # compression sampling), not pyarrow.Buffer
    return {"serializer": "arrow", "kind": kind}, [memoryview(sink.getvalue())]


def _arrow_loads(header: dict, frames: list):
    import pyarrow as pa

    with pa.ipc.open_stream(pa.py_buffer(frames[0])) as reader:
        table = reader.read_all()
    if header.get("kind") == "batch":
        batches = table.combine_chunks().to_batches()
        if batches:
            return batches[0]
        # zero-row tables yield no batches; rebuild an empty one
        return pa.RecordBatch.from_arrays(
            [pa.array([], type=f.type) for f in table.schema],
            schema=table.schema,
        )
    return table


register_serialization_family("arrow", _arrow_dumps, _arrow_loads)


def _error_dumps(x: Any) -> tuple[dict, list]:
    return {"serializer": "error"}, [repr(x).encode()[:10_000]]


def _error_loads(header: dict, frames: list) -> Any:
    # graft-lint: allow[wire-no-copy] error-family repr, capped at 10 kB upstream
    raise TypeError(f"Could not deserialize object: {bytes(frames[0])!r}")


register_serialization_family("error", _error_dumps, _error_loads)


def _family_for(x: Any) -> str:
    # dispatch by type without importing heavyweight modules
    mod = type(x).__module__
    if mod == "numpy":
        import numpy as np

        if isinstance(x, np.ndarray) and x.dtype != object:
            return "numpy"
    if mod.startswith("torch"):
        import torch

        if isinstance(x, torch.Tensor) and not x.is_sparse:
            return "torch"
    if mod.startswith("pyarrow"):
        import pyarrow as pa

        if isinstance(x, (pa.Table, pa.RecordBatch)):
            return "arrow"
    return "pickle"


_counts: dict[str, dict[str, int]] = {}
_counts_lock = threading.Lock()


def _count(header: dict, frames: list, side: str) -> None:
    """One call of ``header``'s family on ``side`` ("dumps" or "loads")."""
    nbytes = sum(len(f) if isinstance(f, (bytes, bytearray)) else memoryview(f).nbytes
                 for f in frames)
    name = header.get("serializer", "pickle")
    with _counts_lock:
        c = _counts.setdefault(name, {"dumps": 0, "loads": 0, "dumps_bytes": 0, "loads_bytes": 0})
        c[side] += 1
        c[side + "_bytes"] += nbytes


def family_counts() -> dict[str, dict[str, int]]:
    """Per family, the calls :func:`serialize` and :func:`deserialize` made
    of it since the last reset and the frame bytes they carried:
    ``{name: {"dumps", "loads", "dumps_bytes", "loads_bytes"}}``."""
    with _counts_lock:
        return {name: dict(c) for name, c in _counts.items()}


def reset_family_counts() -> None:
    with _counts_lock:
        _counts.clear()


def serialize(x: Any, serializers: tuple[str, ...] | None = None) -> tuple[dict, list]:
    """Serialize one object -> (header, frames).  ``frames`` may contain
    memoryviews (zero-copy out-of-band buffers)."""
    if isinstance(x, Serialized):
        return x.header, x.frames
    if isinstance(x, Serialize):
        x = x.data
        if isinstance(x, Serialized):
            # double-wrapped (e.g. a forwarding hop re-wrapped opaque
            # frames): emit the frames, never pickle the wrapper object
            return x.header, x.frames
    header, frames = _serialize(x, serializers)
    _count(header, frames, "dumps")
    return header, frames


def _serialize(x: Any, serializers: tuple[str, ...] | None) -> tuple[dict, list]:
    name = _family_for(x)
    if serializers is not None and name not in serializers:
        name = serializers[0]
    dumps, _ = families[name]
    try:
        return dumps(x)
    except Exception:
        if name != "pickle" and (serializers is None or "pickle" in serializers):
            try:
                return families["pickle"][0](x)
            except Exception:
                pass
        return families["error"][0](x)


def deserialize(header: dict, frames: list) -> Any:
    name = header.get("serializer", "pickle")
    try:
        _, loads = families[name]
    except KeyError:
        raise ValueError(f"unknown serializer family {name!r}") from None
    out = loads(header, frames)
    _count(header, frames, "loads")
    return out


_ATOMS = frozenset({str, int, float, bool, bytes, type(None)})


def nested_deserialize(obj: Any) -> Any:
    """Replace Serialize/Serialized wrappers in a message with their values.

    Copy-on-write: control messages (the overwhelmingly common case on
    the inproc data plane) contain no wrappers, and rebuilding every
    dict/list on each ``comm.read`` showed up at ~5% of the config-2
    per-task budget — an unchanged subtree is returned as-is.
    """
    typ = type(obj)
    if typ in _ATOMS:
        return obj
    if typ is dict:
        out = None
        for k, v in obj.items():
            if type(v) in _ATOMS:  # leaves dominate: skip the call
                continue
            r = nested_deserialize(v)
            if r is not v:
                if out is None:
                    out = dict(obj)
                out[k] = r
        return obj if out is None else out
    if typ is list:
        out = None
        for i, v in enumerate(obj):
            if type(v) in _ATOMS:
                continue
            r = nested_deserialize(v)
            if r is not v:
                if out is None:
                    out = list(obj)
                out[i] = r
        return obj if out is None else out
    if typ is tuple:
        changed = False
        vals = []
        for v in obj:
            r = v if type(v) in _ATOMS else nested_deserialize(v)
            if r is not v:
                changed = True
            vals.append(r)
        return tuple(vals) if changed else obj
    if isinstance(obj, Serialize):
        return obj.data
    if isinstance(obj, Serialized):
        return obj.deserialize()
    # subclassed containers (OrderedDict, namedtuple, ...): slow path
    if isinstance(obj, dict):
        return {k: nested_deserialize(v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        vals = [nested_deserialize(v) for v in obj]
        if all(r is v for r, v in zip(vals, obj)):
            return obj
        if hasattr(obj, "_fields"):  # namedtuple: ctor takes *args
            return type(obj)(*vals)
        return type(obj)(vals)
    if isinstance(obj, list):
        return [nested_deserialize(v) for v in obj]
    return obj


def install_serialization(register_serialization_family, families: dict) -> Installed:
    """Register :func:`torch_dumps` / :func:`torch_loads` as the
    ``"torch"`` family through the reference's
    ``register_serialization_family``; ``families`` is the registry it
    writes.  The handle's last ``uninstall()`` puts the reference's own
    entry back: ``families["torch"] is`` the tuple it held before."""

    def apply():
        original = families["torch"]
        register_serialization_family("torch", torch_dumps, torch_loads)
        if families.get("torch") != (torch_dumps, torch_loads):
            families["torch"] = original
            raise ValueError("register_serialization_family does not write the families given")

        def undo():
            families["torch"] = original

        return undo

    return install("serialization", families, (), apply)
