"""The shard collectives: one interface, two ways to hold the shards.

A mesh here is anything with ``size`` (the number of shards) and
``devices`` (each shard's device, in shard order; a device may repeat,
so one card or the CPU can hold several shards): the sharded engine's
``EngineMesh`` and the data plane's ``Mesh1D`` (``ops/ici.py``).  Every
collective takes ``parts``, one tensor for each shard this process
holds (``comm.local``, in shard order), and returns the same.  The calls
are explicit and in a fixed shard order, so one process holding every
shard computes what a process group computes, and one card can check
every layout.

- :class:`LocalShards`: every shard in this process.  ``psum`` adds the
  partials in shard order, ``acc = p[0]; acc = acc + p[1]; ...`` (the
  order XLA's CPU backend adds them), ``all_gather`` concatenates in
  shard order, ``all_to_all`` is the block transpose ``recv[d][s] =
  send[s][d]`` and ``ppermute(shift)`` moves shard ``i``'s tensor to
  shard ``(i + shift) % n``, each result on its shard's device.
- :class:`ProcessGroupShards`: one shard a rank of a
  ``torch.distributed`` group: ``all_reduce``,
  ``all_gather_into_tensor``, ``all_to_all_single`` and
  ``batch_isend_irecv``.

``all_to_all`` and ``ppermute`` are differentiable on both, with the
transposes ``jax.grad`` uses: the backward of ``all_to_all`` is
``all_to_all`` and that of ``ppermute(shift)`` is ``ppermute(-shift)``.
:class:`LocalShards`' are indexing and ``.to``, which autograd already
follows; :class:`ProcessGroupShards`' go through :class:`_AllToAll` and
:class:`_PPermute`.
"""

from __future__ import annotations

import warnings

import torch


class LocalShards:
    """Every shard of ``mesh`` in this process (``local`` = all of them, in
    shard order).  The collectives are plain tensor ops in shard order."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.n_shards = mesh.size
        self.local = list(range(mesh.size))

    def psum(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The elementwise sum of the shards' partials, added in shard
        order on the first shard's device."""
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p.to(acc.device)
        return acc

    def all_gather(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The shards' slices concatenated in shard order."""
        dev = parts[0].device
        return torch.cat([p.to(dev) for p in parts])

    def gather_workers(self, blocks: list[torch.Tensor]) -> torch.Tensor:
        """The ``workers``-axis blocks of a fleet field, joined in order."""
        return self.all_gather(blocks)

    def all_to_all(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        """``parts[s]`` is ``[n, ...]``, block ``d`` going to shard ``d``;
        returns ``recv[d] = [n, ...]`` with ``recv[d][s] = parts[s][d]``,
        on shard ``d``'s device."""
        n = self.n_shards
        if any(p.shape[0] != n for p in parts):
            raise ValueError(f"all_to_all needs {n} blocks a shard")
        devs = self.mesh.devices
        return [torch.stack([p[d].to(devs[d]) for p in parts]) for d in range(n)]

    def ppermute(self, parts: list[torch.Tensor], shift: int = 1) -> list[torch.Tensor]:
        """Shard ``i``'s tensor moves to shard ``(i + shift) % n``."""
        n = self.n_shards
        devs = self.mesh.devices
        return [parts[(d - shift) % n].to(devs[d]) for d in range(n)]


class ProcessGroupShards:
    """One shard a rank: rank ``r`` of ``group`` (the default group when
    None) holds shard ``r`` of ``mesh``, whose size must be the world's.
    Its device is the mesh's entry for that shard."""

    def __init__(self, mesh, group=None):
        import torch.distributed as dist

        self.dist = dist
        self.group = group
        self.mesh = mesh
        self.n_shards = mesh.size
        world = dist.get_world_size(group)
        if world != mesh.size:
            raise ValueError(f"a mesh of {mesh.size} shards needs {mesh.size} ranks, "
                             f"the group has {world}")
        self.rank = dist.get_rank(group)
        self.local = [self.rank]

    def psum(self, parts: list[torch.Tensor]) -> torch.Tensor:
        out = parts[0].clone()
        self.dist.all_reduce(out, group=self.group)
        return out

    def all_gather(self, parts: list[torch.Tensor]) -> torch.Tensor:
        p = parts[0].contiguous()
        out = torch.empty(self.n_shards * p.numel(), dtype=p.dtype, device=p.device)
        with warnings.catch_warnings():
            # newer torch names it all_gather_single; the card's torch has only this
            warnings.simplefilter("ignore", FutureWarning)
            self.dist.all_gather_into_tensor(out, p, group=self.group)
        return out

    def gather_workers(self, blocks: list[torch.Tensor]) -> torch.Tensor:
        """This rank's block gathered over the whole group, then the blocks
        of the first ``tasks`` row (every row holds the same blocks)."""
        mine = blocks[self.mesh.workers_index(self.local[0])]
        full = self.all_gather([mine]).view(self.mesh.dt, -1)
        return full[0].contiguous()

    def all_to_all(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        """This rank's ``[n, ...]`` blocks, block ``d`` to rank ``d``;
        returns ``[n, ...]`` whose block ``s`` came from rank ``s``."""
        if parts[0].shape[0] != self.n_shards:
            raise ValueError(f"all_to_all needs {self.n_shards} blocks a shard")
        return [_AllToAll.apply(self, parts[0])]

    def ppermute(self, parts: list[torch.Tensor], shift: int = 1) -> list[torch.Tensor]:
        """This rank's tensor goes to rank ``(r + shift) % n``; returns the
        one from rank ``(r - shift) % n``."""
        return [_PPermute.apply(self, parts[0], shift)]

    def _all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        send = send.contiguous()
        out = torch.empty_like(send)
        self.dist.all_to_all_single(out, send, group=self.group)
        return out

    def _ppermute(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        n, r = self.n_shards, self.rank
        x = x.contiguous()
        dst, src = (r + shift) % n, (r - shift) % n
        if dst == r:
            return x.clone()
        out = torch.empty_like(x)
        g = self.group
        peer = self.dist.get_global_rank if g is not None else (lambda _g, i: i)
        ops = [self.dist.P2POp(self.dist.isend, x, peer(g, dst), g),
               self.dist.P2POp(self.dist.irecv, out, peer(g, src), g)]
        for req in self.dist.batch_isend_irecv(ops):
            req.wait()
        return out


class _AllToAll(torch.autograd.Function):
    """A rank's block transpose; its backward is the same exchange of the
    gradient (``recv[d][s] = send[s][d]`` is its own transpose)."""

    @staticmethod
    def forward(ctx, comm, send):
        ctx.comm = comm
        return comm._all_to_all(send)

    @staticmethod
    def backward(ctx, grad):
        return None, ctx.comm._all_to_all(grad)


class _PPermute(torch.autograd.Function):
    """A ring shift; its backward shifts the gradient back."""

    @staticmethod
    def forward(ctx, comm, x, shift):
        ctx.comm, ctx.shift = comm, shift
        return comm._ppermute(x, shift)

    @staticmethod
    def backward(ctx, grad):
        return None, ctx.comm._ppermute(grad, -ctx.shift), None
