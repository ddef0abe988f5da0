"""The device data plane, PyTorch + CUDA port (kernel K12).

The counterpart of ``distributed_tpu/ops/ici.py``: a hash shuffle of
``(key, value)`` rows over a 1-D mesh of shards, and the ring step that
ring attention builds on.  The reference runs each as one ``shard_map``
program; here the shard body and the collective are separate, explicit
calls:

- the bucket pass (the reference's ``_shuffle_program.local``): each
  shard sends row ``i`` to shard ``mix32(key) % n``, its rows kept in
  source order inside each destination's block, each ``(src -> dst)``
  block padded with zeros to ``capacity``; a row past the capacity is
  dropped but still counted, and a masked row (``valid`` False) goes
  nowhere and counts nowhere.  :func:`shuffle_bucket_reference` is that
  body in torch ops (the CPU path, and the plain version the kernel is
  held against); :func:`shuffle_bucket_cuda` is the hand-written kernel
  ``csrc/shuffle_bucket.cu``, every shard of one device in one call;
- the exchange: the comm interface's ``all_to_all`` of keys, values and
  the true counts (``ops/comm.py``: :class:`LocalShards` in one process,
  :class:`ProcessGroupShards` one shard a rank);
- :func:`ring_exchange`: the comm interface's ``ppermute``.

Inputs are either one global array (split evenly over the mesh, as the
reference shards it) or a list of the tensors of the shards this process
holds; outputs are lists over those shards, each on its shard's device.
A CUDA shard runs the kernel, a CPU shard the plain version; nothing
moves from one to the other when the kernel cannot be built or launched.

Capacity contract, as in the reference: the TRUE counts travel with the
data, so a count above the capacity means that block was truncated, and
:func:`compact_shuffle_output` raises on it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from distributed_tpu_torch._device import resolve_device
from distributed_tpu_torch.ops import _build
from distributed_tpu_torch.ops.comm import LocalShards

_M32 = 0xFFFFFFFF
MAX_DESTS_CUDA = 1024  # the kernel's per-block tables hold this many destinations
SHUFFLE_TILE = 2048  # rows a block of the histogram and scatter launches (csrc kTile)


@dataclass(frozen=True)
class Mesh1D:
    """A 1-D mesh of shards named ``axis``; ``devices`` lists each shard's
    device in shard order and may repeat one device."""

    axis: str
    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis: self.size}


def make_mesh_1d(n: int | None = None, axis: str = "shuffle", devices=None) -> Mesh1D:
    """A mesh over the first ``n`` devices (all of them for ``None``/0):
    the visible CUDA devices by default (raising without one), or the
    given list, which may repeat a device (``["cpu"] * 8``, ``["cuda:0"]
    * 8``).  Asking for more devices than there are raises ``ValueError``."""
    if devices is None:
        first = resolve_device(None)
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())] or [first]
    devices = [resolve_device(d) for d in devices]
    n = n or len(devices)
    if n > len(devices):
        raise ValueError(f"requested a {n}-device mesh but only {len(devices)} devices "
                         f"are available")
    return Mesh1D(axis, tuple(devices[:n]))


def _mul32(z: torch.Tensor, c: int) -> torch.Tensor:
    """``z * c mod 2**32`` for ``z`` in [0, 2**32) in int64, split in two
    16-bit halves of ``c`` so no product leaves int64's range."""
    lo = z * (c & 0xFFFF)
    hi = ((z * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x) -> torch.Tensor:
    """The reference's murmur3 finalizer on ``x`` cast to uint32 (negative
    int32 keys wrap as two's complement), as int64 in [0, 2**32)."""
    z = torch.as_tensor(x).to(torch.int64) & _M32
    z = z ^ (z >> 16)
    z = _mul32(z, 0x85EBCA6B)
    z = z ^ (z >> 13)
    z = _mul32(z, 0xC2B2AE35)
    return z ^ (z >> 16)


def default_capacity(n_local: int, n_dev: int) -> int:
    """2x headroom over the uniform expectation, at least 16."""
    return max(16, (2 * n_local + n_dev - 1) // n_dev)


# ------------------------------------------------------------ bucket pass


def shuffle_bucket_reference(keys, values, valid, n_dev: int, capacity: int):
    """Plain version of one shard's bucket pass: ``keys [n]``, ``values
    [n, ...]``, ``valid`` bool ``[n]`` or None -> ``(send_k [n_dev, B],
    send_v [n_dev, B, ...], sent i32 [n_dev])``, the reference's
    ``local`` body step for step (a stable sort by destination, a
    bincount that leaves out masked rows, the rank inside a block from
    the block starts)."""
    n = keys.shape[0]
    dev = keys.device
    B = int(capacity)
    dest = _mix32(keys) % n_dev
    if valid is not None:
        dest = torch.where(valid.to(torch.bool), dest, n_dev)
    order = torch.argsort(dest, stable=True)
    sdest = dest[order]
    counts = torch.bincount(dest, minlength=n_dev + 1)[:n_dev]
    starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
    within = torch.arange(n, device=dev) - starts[torch.clamp_max(sdest, n_dev - 1)]
    in_cap = (within < B) & (sdest < n_dev)
    rows = torch.where(in_cap, sdest, n_dev)
    cols = torch.where(in_cap, within, 0)
    send_k = keys.new_zeros((n_dev + 1, B))
    send_k[rows, cols] = keys[order]
    send_v = values.new_zeros((n_dev + 1, B, *values.shape[1:]))
    send_v[rows, cols] = values[order]
    return send_k[:n_dev], send_v[:n_dev], counts.to(torch.int32)


def _vec_bytes(row_bytes: int, tensors) -> int:
    """The widest copy (16, 8, 4, 2 or 1 bytes) that divides the row and
    every base address."""
    v = 16
    while v > 1 and (row_bytes % v or any(t.data_ptr() % v for t in tensors)):
        v //= 2
    return v


def shuffle_bucket_cuda(keys: list, values: list, valid: list | None, n_dev: int,
                        capacity: int):
    """The hand-written kernel over every shard of one CUDA device: lists
    of ``keys`` i32 ``[n]``, ``values [n, ...]`` (any dtype and row width)
    and ``valid`` bool ``[n]`` (or None), one entry a shard, all of one
    length -> lists ``send_k``, ``send_v`` and ``sent`` as the plain
    version returns them, bit for bit.  Four launches on the current
    stream: a histogram a tile, a scan over tiles in tile order, the
    in-order scatter, the zero tail of each block (the scan and the tail
    alone when the shards hold no rows)."""
    dev = keys[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"shuffle_bucket_cuda needs CUDA tensors, got {dev}")
    S = len(keys)
    n = int(keys[0].shape[0])
    B = int(capacity)
    if not 1 <= n_dev <= MAX_DESTS_CUDA:
        raise ValueError(f"the kernel takes 1..{MAX_DESTS_CUDA} destinations, got {n_dev}")
    if B < 1 or n >= 2 ** 31 or n_dev * B >= 2 ** 31:
        raise ValueError(f"capacity {B} and {n} rows out of the kernel's range")
    row_shape = tuple(values[0].shape[1:])
    vdtype = values[0].dtype
    for i in range(S):
        if keys[i].dtype != torch.int32 or keys[i].shape != (n,):
            raise ValueError("keys must be int32 [n], one length for every shard")
        if values[i].shape != (n, *row_shape) or values[i].dtype != vdtype:
            raise ValueError("values must be [n, ...] of one shape and dtype")
        if valid is not None and (valid[i].dtype != torch.bool or valid[i].shape != (n,)):
            raise ValueError("valid must be bool [n]")
    tensors = keys + values + (valid or [])
    if any(t.device != dev for t in tensors):
        raise ValueError("every shard of one call must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("keys, values and valid must be contiguous")
    row_bytes = int(np.prod(row_shape, dtype=np.int64)) * values[0].element_size()
    send_k = [torch.empty((n_dev, B), dtype=torch.int32, device=dev) for _ in range(S)]
    send_v = [torch.empty((n_dev, B, *row_shape), dtype=vdtype, device=dev) for _ in range(S)]
    sent = torch.empty((S, n_dev), dtype=torch.int32, device=dev)
    tiles = -(-n // SHUFFLE_TILE)
    hist = torch.empty(max(S * tiles * n_dev, 1), dtype=torch.int32, device=dev)

    def table(ts):
        return torch.tensor([t.data_ptr() for t in ts], dtype=torch.int64, device=dev)

    vec = _vec_bytes(row_bytes, values + send_v) if row_bytes else 1
    tabs = [table(keys), table(values), table(valid) if valid is not None else None,
            table(send_k), table(send_v)]
    lib = _build.load()
    P = _build.ptr
    rc = lib.dtpu_shuffle_bucket(
        *(P(t) if t is not None else None for t in tabs), P(sent), P(hist),
        S, n, n_dev, B, row_bytes, vec, _build.stream_handle(dev),
    )
    _build.check(rc, "dtpu_shuffle_bucket")
    shuffle_bucket_cuda.launches += 4 if tiles else 2
    return send_k, send_v, list(sent.unbind(0))


shuffle_bucket_cuda.launches = 0  # kernel launches in this process (four a call with rows)


def shuffle_bucket(keys: list, values: list, valid: list | None, n_dev: int, capacity: int):
    """The bucket pass over shards of one device: the plain version shard
    by shard for CPU tensors, the kernel otherwise (which raises off
    CUDA).  Returns lists ``(send_k, send_v, sent)``."""
    if keys[0].device.type == "cpu":
        outs = [shuffle_bucket_reference(keys[i], values[i],
                                         None if valid is None else valid[i], n_dev, capacity)
                for i in range(len(keys))]
        return [list(x) for x in zip(*outs)]
    return shuffle_bucket_cuda(keys, values, valid, n_dev, capacity)


# ----------------------------------------------------------------- shuffle


def local_parts(mesh, comm, x) -> list[torch.Tensor]:
    """The tensors of the shards ``comm`` holds, each on its shard's
    device: ``x`` is a list of them, or one global array split evenly
    over the mesh along its first axis."""
    devs = [mesh.devices[d] for d in comm.local]
    if isinstance(x, (list, tuple)):
        if len(x) != len(devs):
            raise ValueError(f"{len(x)} shards given, this process holds {len(devs)}")
        return [torch.as_tensor(p).to(dv) for p, dv in zip(x, devs)]
    x = torch.as_tensor(x)
    n = mesh.size
    if x.shape[0] % n:
        raise ValueError(f"a first axis of {x.shape[0]} does not split over {n} shards")
    chunks = x.split(x.shape[0] // n)
    return [chunks[d].to(dv) for d, dv in zip(comm.local, devs)]


def _by_device(parts: list[torch.Tensor]) -> dict:
    """Positions into ``parts`` grouped by their tensor's device, in order."""
    groups: dict = {}
    for i, p in enumerate(parts):
        groups.setdefault(p.device, []).append(i)
    return groups


def shuffle_on_mesh(mesh: Mesh1D, keys, values, axis: str = "shuffle",
                    capacity: int | None = None, valid=None, comm=None):
    """Hash shuffle: row ``(k, v)`` moves to shard ``mix32(k) % n``.

    ``keys`` int ``[N]`` and ``values [N, ...]`` (and ``valid`` bool
    ``[N]``, False rows dropped): global arrays split over ``mesh[axis]``
    or lists of this process's shards.  Returns ``(keys_out, values_out,
    counts, sent)``, lists over this process's shards: ``[n_dev, B]`` /
    ``[n_dev, B, ...]`` receive buffers, block ``s`` from shard ``s``, and
    the TRUE counts received and sent ``[n_dev]``; mask a block with
    ``min(count, B)``.  ``comm`` defaults to :class:`LocalShards`."""
    n_dev = mesh.shape[axis]
    comm = comm or LocalShards(mesh)
    kp = local_parts(mesh, comm, keys)
    vp = local_parts(mesh, comm, values)
    mp = None if valid is None else [m.to(torch.bool) for m in local_parts(mesh, comm, valid)]
    if capacity is None:
        capacity = default_capacity(int(kp[0].shape[0]), n_dev)
    S = len(kp)
    send_k, send_v, sent = [None] * S, [None] * S, [None] * S
    for idx in _by_device(kp).values():
        sk, sv, sc = shuffle_bucket(
            [kp[i].contiguous() for i in idx], [vp[i].contiguous() for i in idx],
            None if mp is None else [mp[i].contiguous() for i in idx], n_dev, int(capacity))
        for j, i in enumerate(idx):
            send_k[i], send_v[i], sent[i] = sk[j], sv[j], sc[j]
    recv_k = comm.all_to_all(send_k)
    recv_v = comm.all_to_all(send_v)
    recv_c = [c[:, 0] for c in comm.all_to_all([c[:, None] for c in sent])]
    return recv_k, recv_v, recv_c, sent


def compact_shuffle_output(keys_out, values_out, counts, n_dev: int):
    """Strip the padding: per shard ``(keys, values)``, the valid rows of
    every source block in source order, on the shard's device.  Takes
    :func:`shuffle_on_mesh`'s lists.  Raises ``ValueError`` when a true
    count is above the capacity (that block was truncated)."""
    cnt = np.stack([np.asarray(c.cpu() if torch.is_tensor(c) else c) for c in counts])
    cnt = cnt.reshape(len(keys_out), n_dev)
    B = keys_out[0].shape[1]
    if (cnt > B).any():
        over = np.argwhere(cnt > B)[0]
        raise ValueError(
            f"shuffle block truncated: count {cnt[tuple(over)]} > capacity {B} for "
            f"(dst, src)={tuple(int(i) for i in over)}; re-run shuffle_on_mesh with "
            f"capacity >= {int(cnt.max())}")
    out = []
    for d in range(len(keys_out)):
        ks = [keys_out[d][s, : int(cnt[d, s])] for s in range(n_dev)]
        vs = [values_out[d][s, : int(cnt[d, s])] for s in range(n_dev)]
        out.append((torch.cat(ks), torch.cat(vs)))
    return out


def ring_exchange(mesh: Mesh1D, x, axis: str = "shuffle", shift: int = 1, comm=None):
    """One ring step: shard ``i``'s tensor moves to shard ``(i + shift) %
    n`` (the comm interface's ``ppermute``).  ``x`` is a global array or a
    list of this process's shards; returns the list."""
    if axis not in mesh.shape:
        raise ValueError(f"the mesh has no axis {axis!r}")
    comm = comm or LocalShards(mesh)
    return comm.ppermute(local_parts(mesh, comm, x), shift)
