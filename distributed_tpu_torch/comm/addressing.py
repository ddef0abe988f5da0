"""Address parsing and normalization (reference comm/addressing.py).

Addresses look like ``scheme://host:port`` (``tcp://127.0.0.1:8786``,
``tls://...``, ``inproc://<uuid>/<n>``).  A bare ``host:port`` gets the
configured default scheme.
"""

from __future__ import annotations

from distributed_tpu_torch import config


def parse_address(addr: str, strict: bool = False) -> tuple[str, str]:
    """Split ``scheme://loc`` -> (scheme, loc)."""
    if not isinstance(addr, str):
        raise TypeError(f"expected str address, got {addr!r}")
    if "://" in addr:
        scheme, loc = addr.split("://", 1)
        return scheme, loc
    if strict:
        raise ValueError(f"invalid address {addr!r}: missing scheme")
    return config.get("comm.default-scheme"), addr


def unparse_address(scheme: str, loc: str) -> str:
    return f"{scheme}://{loc}"


def normalize_address(addr: str) -> str:
    return unparse_address(*parse_address(addr))


def parse_host_port(loc: str, default_port: int = 0) -> tuple[str, int]:
    """``host:port`` (with [v6] brackets) -> (host, port)."""
    if loc.startswith("["):  # IPv6
        host, _, rest = loc[1:].partition("]")
        port = int(rest.lstrip(":") or default_port)
        return host, port
    if ":" in loc:
        host, _, port_s = loc.rpartition(":")
        return host, int(port_s or default_port)
    return loc, default_port


def unparse_host_port(host: str, port: int | None = None) -> str:
    if ":" in host and not host.startswith("["):
        host = f"[{host}]"
    return f"{host}:{port}" if port is not None else host


def get_address_host(addr: str) -> str:
    scheme, loc = parse_address(addr)
    if scheme == "inproc":
        return loc.split("/")[0]
    return parse_host_port(loc)[0]


def get_address_host_port(addr: str) -> tuple[str, int]:
    _, loc = parse_address(addr)
    return parse_host_port(loc)


def resolve_address(addr: str) -> str:
    """Resolve hostname to IP, keeping scheme and port."""
    import socket

    scheme, loc = parse_address(addr)
    if scheme == "inproc":
        return addr
    host, port = parse_host_port(loc)
    try:
        host = socket.gethostbyname(host)
    except OSError:
        pass
    return unparse_address(scheme, unparse_host_port(host, port))
