"""The ``"torch"`` serialization family, for tensors on the CPU and on
the card.

The reference's ``torch`` family (``distributed_tpu/protocol/serialize.py:
277-302``) records no device and loads every tensor on the CPU, so a
device-shuffle output sent between workers lands on the host.  This
family keeps the reference's wire and adds the device:

- a CPU tensor gives the reference's header and frame bytes exactly, and
  loads as the reference loads it, so a peer that runs only the
  reference's family interoperates;
- a CUDA tensor pays one device-to-host copy, as the reference's ``jax``
  family pays for an accelerator array (``:236-266``), and its header also
  records ``"device": "cuda"``, as the jax family records ``platform``.
  ``torch_loads`` puts it on the receiver's current CUDA device
  (``resolve_device(None)``), and raises on a receiver with no card: it
  never keeps a CPU tensor where a CUDA one was sent;
- a dtype numpy cannot hold (bfloat16) raises in ``torch_dumps``, as the
  reference's families raise (``_numpy_dumps``: ``cannot include dtype
  'E'`` for a bf16 jax array), so ``serialize`` takes its pickle fallback
  (``:398-405``), as it does for a bf16 jax array.

:func:`install_serialization` registers the family over ``"torch"``
through the reference's ``register_serialization_family``, passed in; the
reference already sends every dense tensor to that family
(``_family_for``, ``:371-375``).

Beside the family stand the reference's protocol wrappers (``Serialize``,
``Serialized``, ``ToPickle``, ``Pickled``) and the helpers the control
plane calls, copied line for line: ``wrap_opaque`` (``:106``),
``compact_frames`` (``:118``) and ``unwrap`` (``:155``).  The wire's
``deserialize`` (the family registry, pickle) is not in the port yet, so
unwrapping a ``Serialized`` or ``Pickled`` payload raises
``NotImplementedError``; a ``Serialize`` or ``ToPickle`` wrapper, which is
what an in-process hop carries, unwraps as in the reference.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from distributed_tpu_torch._device import resolve_device
from distributed_tpu_torch._install import Installed, install


def _numpy_dumps(x: np.ndarray) -> tuple[dict, list]:
    """The reference's ``_numpy_dumps`` (``serialize.py:213-222``)."""
    x = np.ascontiguousarray(x)
    header = {"serializer": "numpy", "dtype": x.dtype.str, "shape": list(x.shape)}
    return header, [x.data.cast("B")]


def _numpy_loads(header: dict, frames: list) -> np.ndarray:
    """The reference's ``_numpy_loads`` (``serialize.py:225-230``)."""
    arr = np.frombuffer(frames[0], dtype=np.dtype(header["dtype"]))
    return arr.reshape(header["shape"])


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


def deserialize(header: dict, frames: list) -> Any:
    """The wire's decode, which the port does not have yet."""
    raise NotImplementedError(
        "deserializing a wire payload needs the port's comm and wire "
        "(ROADMAP queue 1: the asyncio Scheduler and Worker servers)"
    )
