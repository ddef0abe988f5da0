from distributed_tpu_torch.deploy.local import LocalCluster
from distributed_tpu_torch.deploy.spec import Adaptive, Cluster, SpecCluster
from distributed_tpu_torch.deploy.ssh import SSHCluster
from distributed_tpu_torch.deploy.subprocess import (
    SubprocessCluster,
    SubprocessScheduler,
    SubprocessWorker,
)

__all__ = [
    "Adaptive",
    "Cluster",
    "LocalCluster",
    "SSHCluster",
    "SpecCluster",
    "SubprocessCluster",
    "SubprocessWorker",
    "SubprocessScheduler",
]
