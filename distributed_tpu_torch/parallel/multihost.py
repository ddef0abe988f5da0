"""Multi-process ``torch.distributed`` bring-up for the device plane.

The counterpart of ``distributed_tpu/parallel/multihost.py``, which wires
every worker process into one ``jax.distributed`` runtime.  Here the
runtime is a ``torch.distributed`` process group: each process owns one
shard of a 1-D mesh (rank ``r`` holds shard ``r``), and the data plane's
collectives run over it through ``ops.comm.ProcessGroupShards``
(``all_to_all_single``, ``batch_isend_irecv``).  NCCL is the backend on
the card; gloo runs the same calls on the CPU.

Nothing on a machine tells a process of its cluster: the caller passes
the coordinator's ``host:port``, this process's rank and the world size.
"""

from __future__ import annotations

import logging

import torch

logger = logging.getLogger("distributed_tpu_torch.multihost")


def maybe_initialize(
    coordinator: str | None,
    process_id: int | None = None,
    num_processes: int | None = None,
    local_device_ids: list[int] | None = None,
    backend: str | None = None,
) -> bool:
    """Idempotently join the process group at ``tcp://coordinator``.

    No-op (returns False) when ``coordinator`` is None.  ``backend`` is
    ``nccl`` unless the caller asks for another (``"gloo"`` on the CPU);
    with ``local_device_ids`` the first one becomes this process's current
    CUDA device.  Returns True once the group exists."""
    import torch.distributed as dist

    if coordinator is None:
        return False
    if dist.is_initialized():
        return True
    if local_device_ids:
        torch.cuda.set_device(int(local_device_ids[0]))
    dist.init_process_group(
        backend or "nccl",
        init_method=f"tcp://{coordinator}",
        world_size=int(num_processes if num_processes is not None else 1),
        rank=int(process_id if process_id is not None else 0),
    )
    logger.info("torch.distributed initialized: process %s/%s via %s (%s)",
                process_id, num_processes, coordinator, dist.get_backend())
    return True


def is_multihost() -> bool:
    """True when this process is one of several in a process group."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def local_device_indices(n_devices: int | None = None) -> list[int]:
    """Global mesh indices (= shuffle partition ids) this process owns:
    its rank's shard when a group exists, else every index below
    ``n_devices`` (one process holds the whole mesh)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        rank = dist.get_rank()
        return [rank] if n_devices is None or rank < n_devices else []
    return list(range(n_devices or 1))
