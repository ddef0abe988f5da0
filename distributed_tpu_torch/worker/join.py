"""A worker's process-group join, before it registers.

The counterpart of the reference's ``--jax-coordinator`` /
``--jax-process-id`` / ``--jax-num-processes`` (``cli/worker.py:57-111``)
and ``Worker.start_unsafe``'s join (``worker/server.py:312-337``): the
worker joins the device runtime off the event loop, then registers the
mesh indices its process owns as ``jax_devices`` (``:571``), which the
shuffle's device ownership reads (``shuffle/scheduler_ext.py:101-118``).
The scheduler reads that list only from the registration message, so the
join must run before it: from a config preload (``worker.preload``), which
the worker runs before ``_register_with_scheduler``, never from the CLI's
``--preload``, which runs after the worker has registered.

The rendezvous is torch's own environment, what ``torchrun`` sets:
``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, and
``LOCAL_RANK`` for the card.  ``--jax-cpu-devices`` (virtual CPU devices
of a jax process) has no torch meaning: a gloo rank is one shard, so
nothing here stands for it.
"""

from __future__ import annotations

import asyncio
import os
import threading

import torch

from distributed_tpu_torch._device import resolve_device
from distributed_tpu_torch._install import Installed, install, install_count
from distributed_tpu_torch.parallel import multihost

RENDEZVOUS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def _env_int(name: str) -> int:
    value = os.environ.get(name)
    if value is None:
        raise RuntimeError(f"MASTER_ADDR is set but {name} is not: the process group's "
                           f"rendezvous needs {', '.join(RENDEZVOUS)} (and LOCAL_RANK on CUDA)")
    return int(value)


GROUP = "process_group"  # the install that counts the workers holding the port's group
_lock = threading.Lock()  # one join at a time: a LocalCluster's workers start together


def _destroy_group() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


async def _join(worker, device, backend, hold: bool) -> tuple[bool, Installed | None]:
    import torch.distributed as dist

    if "MASTER_ADDR" not in os.environ:
        return False, None
    dev = resolve_device(device)
    coordinator = f"{os.environ['MASTER_ADDR']}:{_env_int('MASTER_PORT')}"
    rank, world = _env_int("RANK"), _env_int("WORLD_SIZE")
    local = None
    if dev.type == "cuda":
        local = [_env_int("LOCAL_RANK")]
        torch.cuda.set_device(local[0])  # this thread's card; maybe_initialize sets the joining thread's
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")

    def join():
        with _lock:
            created = not dist.is_initialized()
            if created:
                multihost.maybe_initialize(coordinator, rank, world, local_device_ids=local,
                                           backend=backend)
            elif (dist.get_rank(), dist.get_world_size()) != (rank, world):
                raise RuntimeError(
                    f"a process group of rank {dist.get_rank()} in {dist.get_world_size()} "
                    f"already exists; the environment asks for rank {rank} in {world}")
            held = None
            if hold and (created or install_count(GROUP, dist)):
                held = install(GROUP, dist, (), lambda: _destroy_group)
            return created, held

    created, held = await asyncio.get_running_loop().run_in_executor(None, join)
    worker.jax_device_indices = multihost.local_device_indices()
    return created, held


async def join_process_group(worker, *, device=None, backend=None) -> bool:
    """Join ``torch.distributed``'s process group from the environment and
    set ``worker.jax_device_indices`` to the mesh indices this process
    owns (``[RANK]``).  Returns True when this call created the group,
    False when it joined none or found one.

    Without ``MASTER_ADDR`` it joins nothing, as the reference without
    ``--jax-coordinator``: the worker then registers ``jax_devices: None``.
    ``device=None`` means CUDA (the card of ``LOCAL_RANK``, backend NCCL)
    and raises without one; ``device="cpu"`` uses gloo.  A group that
    already exists is used only if its rank and world size are the
    environment's; otherwise this raises (``maybe_initialize`` would
    accept any group)."""
    created, _ = await _join(worker, device, backend, hold=False)
    return created


async def hold_process_group(worker, *, device=None, backend=None) -> Installed | None:
    """:func:`join_process_group`, counted as the installs are: every
    worker of the process that joins the group the port's joins created
    holds one count on it, and the last holder's ``uninstall()`` destroys
    it, so a worker that closes first leaves the group to the others.  A
    group made outside the port is its maker's: no hold is taken on it, and
    None is returned, as it is when nothing joins (no ``MASTER_ADDR``)."""
    _, held = await _join(worker, device, backend, hold=True)
    return held
