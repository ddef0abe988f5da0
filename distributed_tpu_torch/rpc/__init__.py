from distributed_tpu_torch.rpc.batched import BatchedSend
from distributed_tpu_torch.rpc.core import (
    AsyncTaskGroup,
    ConnectionPool,
    PeriodicCallback,
    PooledRPCCall,
    Server,
    Status,
    clean_exception,
    error_message,
    raise_remote_error,
    rpc,
    send_recv,
)

__all__ = [
    "Server", "Status", "rpc", "send_recv", "ConnectionPool", "PooledRPCCall",
    "BatchedSend", "AsyncTaskGroup", "PeriodicCallback", "error_message",
    "raise_remote_error", "clean_exception",
]
