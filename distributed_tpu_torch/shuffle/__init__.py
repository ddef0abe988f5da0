"""P2P shuffle, the port's copy of ``distributed_tpu/shuffle/__init__.py``'s exports:
the host engine (``core.py``, ``buffers.py``, ``columnar.py``), its
scheduler extension (``scheduler_ext.py``), the graph builders
(``api.py``) and the device-resident shuffle (``device.py``, kernel K12)."""

from distributed_tpu_torch.shuffle.api import (
    p2p_merge,
    p2p_merge_arrays,
    p2p_rechunk,
    p2p_shuffle,
    p2p_shuffle_arrays,
)
from distributed_tpu_torch.shuffle.buffers import (
    CommShardsBuffer,
    DiskShardsBuffer,
    MemoryShardsBuffer,
    ResourceLimiter,
)
from distributed_tpu_torch.shuffle.core import (
    ShuffleRun,
    ShuffleSpec,
    ShuffleWorkerExtension,
)
from distributed_tpu_torch.shuffle.device import (
    DeviceShuffleStore,
    device_store,
    p2p_shuffle_device,
)
from distributed_tpu_torch.shuffle.scheduler_ext import ShuffleSchedulerExtension

__all__ = [
    "p2p_shuffle",
    "p2p_shuffle_arrays",
    "p2p_shuffle_device",
    "DeviceShuffleStore",
    "device_store",
    "p2p_rechunk",
    "p2p_merge",
    "p2p_merge_arrays",
    "ShuffleRun",
    "ShuffleSpec",
    "ShuffleWorkerExtension",
    "ShuffleSchedulerExtension",
    "ResourceLimiter",
    "MemoryShardsBuffer",
    "DiskShardsBuffer",
    "CommShardsBuffer",
]
