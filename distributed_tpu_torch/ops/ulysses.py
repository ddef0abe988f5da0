"""All-to-all (Ulysses) sequence parallelism, PyTorch + CUDA port: the forward.

The counterpart of ``distributed_tpu/ops/ulysses.py``: one ``all_to_all``
re-shards ``[seq / n, heads, dim]`` shards to ``[seq, heads / n, dim]``,
every shard runs attention over the whole sequence for its head group,
and a second ``all_to_all`` restores the sequence sharding.  The
exchanges are the comm interface's (``ops/comm.py``); the local attention
is kernel K2 on the card at every sequence length (it masks ragged
tiles), and on the CPU the reference's ``_local_attention`` branch: flash
attention's plain version when the sequence divides by ``min(128, seq)``,
else the plain ``O(N^2)`` einsum.
"""

from __future__ import annotations

from distributed_tpu_torch.ops import flash
from distributed_tpu_torch.ops.comm import LocalShards
from distributed_tpu_torch.ops.ici import local_parts


def _local_attention(q, k, v, causal: bool, scale: float):
    """Full-sequence attention for this shard's head group: K2 (forward
    and recompute backward) off the CPU, which raises where K2 cannot take
    the shape; the reference's branch on it."""
    n = q.shape[0]
    if q.device.type != "cpu":
        qt, kt, vt = (x.transpose(0, 1).contiguous() for x in (q, k, v))
        return flash._FlashAttention.apply(qt, kt, vt, causal, scale, 128).transpose(0, 1)
    if n % min(128, n) == 0:
        return flash.flash_attention(q, k, v, causal=causal, scale=scale, device=q.device)
    return flash.reference_attention(q, k, v, causal=causal, scale=scale)


def seq_to_heads(comm, parts, n_dev: int):
    """``[n_local, H, D]`` sequence shards -> ``[N, H / n, D]`` head
    shards: head group ``g`` of every shard's chunk goes to shard ``g``
    and the chunks join in sequence order."""
    out = []
    send = []
    for x in parts:
        n_local, h, d = x.shape
        send.append(x.reshape(n_local, n_dev, h // n_dev, d).transpose(0, 1).contiguous())
    for r in comm.all_to_all(send):
        out.append(r.reshape(-1, *r.shape[2:]))
    return out


def heads_to_seq(comm, parts, n_dev: int):
    """The inverse: ``[N, H / n, D]`` -> ``[N / n, H, D]``."""
    send = [x.reshape(n_dev, x.shape[0] // n_dev, *x.shape[1:]) for x in parts]
    out = []
    for r in comm.all_to_all(send):
        _, n_local, hg, d = r.shape
        out.append(r.transpose(0, 1).reshape(n_local, n_dev * hg, d))
    return out


def ulysses_attention(mesh, q, k, v, axis: str = "sp", causal: bool = False,
                      scale: float | None = None, comm=None):
    """Exact attention with the sequence sharded over ``mesh[axis]`` through
    two all-to-alls.

    ``q, k, v``: ``[seq, heads, dim]`` global arrays or lists of this
    process's shards; ``heads`` must divide by the axis size.  Returns the
    list of this process's ``[seq / n, heads, dim]`` output shards."""
    n_dev = mesh.shape[axis]
    comm = comm or LocalShards(mesh)
    qs, ks, vs = (local_parts(mesh, comm, x) for x in (q, k, v))
    heads = qs[0].shape[1]
    if heads % n_dev:
        raise ValueError(
            f"heads ({heads}) must divide by the mesh axis ({n_dev}); "
            f"use ring_attention for head counts below the device count")
    if scale is None:
        scale = 1.0 / (qs[0].shape[-1] ** 0.5)
    qh, kh, vh = (seq_to_heads(comm, p, n_dev) for p in (qs, ks, vs))
    outs = [_local_attention(qh[j], kh[j], vh[j], bool(causal), float(scale))
            for j in range(len(qh))]
    return heads_to_seq(comm, outs, n_dev)
