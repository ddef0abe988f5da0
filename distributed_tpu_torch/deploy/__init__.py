"""The port's copy of ``distributed_tpu/deploy/__init__.py`` without
``SSHCluster`` and the ``Subprocess*`` classes: they start their nodes
through the command-line entry points, which are not ported yet."""

from distributed_tpu_torch.deploy.local import LocalCluster
from distributed_tpu_torch.deploy.spec import Adaptive, Cluster, SpecCluster

__all__ = [
    "Adaptive",
    "Cluster",
    "LocalCluster",
    "SpecCluster",
]
