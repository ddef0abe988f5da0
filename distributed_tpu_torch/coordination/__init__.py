"""Cluster-wide coordination primitives, the port's copy of
``distributed_tpu/coordination/__init__.py``'s exports: the scheduler
extensions and the client-side objects."""

from distributed_tpu_torch.coordination.extensions import (
    EventExtension,
    LockExtension,
    MultiLockExtension,
    PublishExtension,
    PubSubSchedulerExtension,
    QueueExtension,
    SemaphoreExtension,
    VariableExtension,
    coordination_extensions,
)
from distributed_tpu_torch.coordination.objects import (
    Event,
    Lock,
    MultiLock,
    Pub,
    Queue,
    Semaphore,
    Sub,
    Variable,
)

__all__ = [
    "Event",
    "Lock",
    "MultiLock",
    "Pub",
    "Queue",
    "Semaphore",
    "Sub",
    "Variable",
    "EventExtension",
    "LockExtension",
    "MultiLockExtension",
    "PublishExtension",
    "PubSubSchedulerExtension",
    "QueueExtension",
    "SemaphoreExtension",
    "VariableExtension",
    "coordination_extensions",
]
