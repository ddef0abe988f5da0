"""Comm abstraction: message-oriented async channels.

The shape follows the reference (comm/core.py): an abstract ``Comm`` whose
``read``/``write`` carry *messages* (arbitrary msgpack-able structures with
``Serialize`` leaves), not bytes; ``Listener``/``Connector`` per scheme in a
registry; ``connect()`` with retry/backoff and a version/compression
handshake; ``listen()``.

Backends in this package:

- ``tcp://`` / ``tls://`` — asyncio streams (comm/tcp.py).  The reference
  uses tornado IOStream; asyncio's loop is the idiomatic substrate here and
  removes the tornado dependency.
- ``inproc://``           — in-process queue pairs (comm/inproc.py)

The TPU data plane does NOT go through these comms: bulk array movement
between chips rides XLA collectives over ICI (see shuffle/ and parallel/),
exactly as the reference routes bulk GPU traffic over UCX instead of its
TCP control plane.  Comms carry control messages and host-side data.
"""

from __future__ import annotations

import asyncio
import logging
import random
from abc import ABC, abstractmethod
from typing import Any, Callable

from distributed_tpu_torch import config
from distributed_tpu_torch.exceptions import CommClosedError, FatalCommClosedError

logger = logging.getLogger("distributed_tpu_torch.comm")


class Comm(ABC):
    """A message-oriented bidirectional channel."""

    _instances: "set[Comm]" = set()

    def __init__(self, deserialize: bool = True):
        self.deserialize = deserialize
        self.name: str | None = None
        self.handshake_options: dict = {}
        Comm._instances.add(self)

    @abstractmethod
    async def read(self) -> Any:
        """Read one message; raises CommClosedError on a closed comm."""

    @abstractmethod
    async def write(self, msg: Any, on_error: str = "message") -> int:
        """Write one message; returns bytes written."""

    @abstractmethod
    async def close(self) -> None:
        """Flush and close."""

    @abstractmethod
    def abort(self) -> None:
        """Close immediately, discarding buffered data."""

    @property
    @abstractmethod
    def local_address(self) -> str: ...

    @property
    @abstractmethod
    def peer_address(self) -> str: ...

    @property
    @abstractmethod
    def closed(self) -> bool: ...

    # -------------------------------------------------------- handshake

    @staticmethod
    def handshake_info() -> dict:
        from distributed_tpu_torch import __version__
        from distributed_tpu_torch.protocol.compression import get_default_compression

        return {
            "compression": get_default_compression()
            if config.get("comm.compression")
            else None,
            "python": tuple(__import__("sys").version_info[:3]),
            "pickle-protocol": 5,
            "version": __version__,
        }

    @staticmethod
    def handshake_configuration(local: dict, remote: dict) -> dict:
        """Negotiate: no compression unless both ends support it."""
        out = {
            "pickle-protocol": min(
                local.get("pickle-protocol", 5), remote.get("pickle-protocol", 5)
            )
        }
        if local.get("compression") == remote.get("compression"):
            out["compression"] = local.get("compression")
        else:
            out["compression"] = None
        return out

    def __repr__(self) -> str:
        clsname = type(self).__name__
        state = " [closed]" if self.closed else ""
        return f"<{clsname}{state} local={self.local_address} remote={self.peer_address}>"


class Listener(ABC):
    @abstractmethod
    async def start(self) -> None: ...

    @abstractmethod
    def stop(self) -> None: ...

    @property
    @abstractmethod
    def listen_address(self) -> str: ...

    @property
    @abstractmethod
    def contact_address(self) -> str: ...

    async def __aenter__(self):
        await self.start()
        return self

    async def __aexit__(self, *exc):
        self.stop()

    async def on_connection(self, comm: Comm) -> None:
        """Server side of the handshake."""
        if getattr(comm, "same_process", False):
            # inproc: both ends share this process — there is nothing to
            # negotiate, and the two-message exchange costs two loop
            # round trips per connection (a 128-worker shuffle opens
            # ~16k pair comms; the handshake storm alone was ~2 s of
            # loop time on the config-4 bench)
            local = Comm.handshake_info()
            comm.remote_info = local
            comm.local_info = local
            comm.handshake_options = Comm.handshake_configuration(local, local)
            return
        try:
            local = Comm.handshake_info()
            timeout = config.parse_timedelta(config.get("comm.timeouts.connect"))
            write = asyncio.create_task(comm.write(local))
            remote = await asyncio.wait_for(comm.read(), timeout)
            await asyncio.wait_for(write, timeout)
        except Exception as e:
            with _ignoring():
                await comm.close()
            raise CommClosedError(f"handshake failed: {e!r}") from e
        comm.remote_info = remote
        comm.local_info = local
        comm.handshake_options = Comm.handshake_configuration(local, remote)


class Connector(ABC):
    @abstractmethod
    async def connect(self, address: str, deserialize: bool = True, **kwargs: Any) -> Comm: ...


class Backend(ABC):
    """Scheme entry: produces connectors/listeners and address helpers."""

    @abstractmethod
    def get_connector(self) -> Connector: ...

    @abstractmethod
    def get_listener(self, loc: str, handle_comm: Callable, deserialize: bool,
                     **kwargs: Any) -> Listener: ...

    def get_address_host(self, loc: str) -> str:
        from distributed_tpu_torch.comm.addressing import parse_host_port

        return parse_host_port(loc)[0]

    def resolve_address(self, loc: str) -> str:
        return loc

    def get_local_address_for(self, loc: str) -> str:
        from distributed_tpu_torch.utils import get_ip

        return get_ip()


backends: dict[str, Backend] = {}


def register_backend(scheme: str, backend: Backend) -> None:
    backends[scheme] = backend


def get_backend(scheme: str) -> Backend:
    _ensure_default_backends()
    try:
        return backends[scheme]
    except KeyError:
        raise ValueError(
            f"unknown address scheme {scheme!r} (known: {sorted(backends)})"
        ) from None


_defaults_loaded = False


def _ensure_default_backends() -> None:
    global _defaults_loaded
    if _defaults_loaded:
        return
    _defaults_loaded = True
    import distributed_tpu_torch.comm.inproc  # noqa: F401 registers inproc
    import distributed_tpu_torch.comm.tcp  # noqa: F401 registers tcp/tls
    import distributed_tpu_torch.comm.ws  # noqa: F401 registers ws


from contextlib import contextmanager


@contextmanager
def _ignoring():
    try:
        yield
    except Exception:
        pass


async def connect(
    addr: str,
    timeout: float | None = None,
    deserialize: bool = True,
    handshake_overrides: dict | None = None,
    **connection_args: Any,
) -> Comm:
    """Connect with exponential backoff until ``timeout`` (reference
    comm/core.py:309)."""
    from distributed_tpu_torch.comm.addressing import parse_address

    if timeout is None:
        timeout = config.parse_timedelta(config.get("comm.timeouts.connect"))
    scheme, loc = parse_address(addr)
    connector = get_backend(scheme).get_connector()

    deadline = asyncio.get_running_loop().time() + timeout
    backoff = 0.01
    error = None
    while True:
        try:
            comm = await asyncio.wait_for(
                connector.connect(loc, deserialize=deserialize, **connection_args),
                max(0.05, deadline - asyncio.get_running_loop().time()),
            )
            break
        except FatalCommClosedError:
            raise
        except (asyncio.TimeoutError, OSError, CommClosedError) as e:
            error = e
            if asyncio.get_running_loop().time() >= deadline:
                raise OSError(
                    f"Timed out trying to connect to {addr} after {timeout} s: {error!r}"
                ) from error
            await asyncio.sleep(backoff * (1 + random.random()))
            backoff = min(backoff * 1.5, 1.0)

    # client side of the handshake
    if getattr(comm, "same_process", False):
        # see Listener.on_connection: inproc skips the exchange on BOTH
        # sides unconditionally (a one-sided skip would deadlock), so
        # handshake_overrides cannot apply to inproc comms
        local = Comm.handshake_info()
        if handshake_overrides:
            local.update(handshake_overrides)
        comm.remote_info = local
        comm.local_info = local
        comm.handshake_options = Comm.handshake_configuration(local, local)
        return comm
    try:
        local = Comm.handshake_info()
        if handshake_overrides:
            local.update(handshake_overrides)
        write = asyncio.create_task(comm.write(local))
        remote = await asyncio.wait_for(
            comm.read(), max(0.05, deadline - asyncio.get_running_loop().time())
        )
        await write
    except Exception as e:
        with _ignoring():
            comm.abort()
        raise OSError(f"connection to {addr} failed during handshake: {e!r}") from e
    comm.remote_info = remote
    comm.local_info = local
    comm.handshake_options = Comm.handshake_configuration(local, remote)
    return comm


def listen(
    addr: str,
    handle_comm: Callable,
    deserialize: bool = True,
    **kwargs: Any,
) -> Listener:
    """Create (not start) a listener on ``addr``: ``handle_comm(comm)`` is
    spawned per accepted connection after the handshake."""
    from distributed_tpu_torch.comm.addressing import parse_address

    scheme, loc = parse_address(addr, strict=False)
    backend = get_backend(scheme)
    return backend.get_listener(loc, handle_comm, deserialize, **kwargs)
