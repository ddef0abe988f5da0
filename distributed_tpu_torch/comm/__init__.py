from distributed_tpu_torch.comm.addressing import (
    get_address_host,
    get_address_host_port,
    normalize_address,
    parse_address,
    parse_host_port,
    resolve_address,
    unparse_address,
    unparse_host_port,
)
from distributed_tpu_torch.comm.core import (
    Comm,
    Connector,
    Listener,
    backends,
    connect,
    get_backend,
    listen,
    register_backend,
)

__all__ = [
    "Comm", "Connector", "Listener", "connect", "listen",
    "backends", "get_backend", "register_backend",
    "parse_address", "unparse_address", "normalize_address",
    "parse_host_port", "unparse_host_port", "resolve_address",
    "get_address_host", "get_address_host_port",
]
