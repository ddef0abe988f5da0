"""Subprocess-backed clusters: scheduler and workers as real OS processes.

Fills the reference's ``deploy/subprocess.py`` role (SubprocessCluster):
every node is a separate Python process started through the ``dtpu-*``
CLI entry points, so the cluster exercises the same code path as a
production deployment (process isolation, TCP transport, signal-driven
shutdown) while remaining a one-liner to start locally.

Design: rather than re-implementing reconciliation, the process handles
(`SubprocessScheduler` / `SubprocessWorker`) satisfy the same small
start/close/address protocol that `SpecCluster` (deploy/spec.py) drives
for in-process workers, so scale()/Adaptive work unchanged on top of OS
processes.  Reference parity: deploy/subprocess.py:61 (SubprocessWorker),
:115 (SubprocessScheduler), :150 (SubprocessCluster).

The port's copy of ``distributed_tpu/deploy/subprocess.py``, line for line
but for the device: nodes start with ``python -m
distributed_tpu_torch.cli.*``, and ``SubprocessCluster(..., device=None)``
puts ``device`` into the scheduler's options, as ``SpecCluster`` does,
which ``SubprocessScheduler`` passes on as ``--device`` (None: the CLI's
default, the card, which raises without one; ``"cpu"`` runs the plain
versions).
"""

from __future__ import annotations

import asyncio
import logging
import os
import sys
from typing import Any, Sequence

from distributed_tpu_torch.deploy.spec import SpecCluster
from distributed_tpu_torch.rpc.core import rpc

logger = logging.getLogger("distributed_tpu_torch.deploy")

_START_TIMEOUT = 60.0


def child_env(extra: dict[str, str] | None = None) -> dict[str, str]:
    """Environment for spawned nodes: repo importable, same backend."""
    repo = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    env = dict(os.environ)
    path = env.get("PYTHONPATH", "")
    if repo not in path.split(os.pathsep):
        env["PYTHONPATH"] = repo + (os.pathsep + path if path else "")
    if extra:
        env.update(extra)
    return env


def device_args(device: Any) -> list[str]:
    """The scheduler CLI's ``--device`` for ``device``; none for None (the
    CLI's default, the card)."""
    return [] if device is None else ["--device", str(device)]


class ProcessHandle:
    """A node living in a child process, started via a CLI entry point.

    Subclasses provide ``_argv()`` and a ``marker`` line prefix; ``start``
    spawns the process and scans merged stdout/stderr until the marker
    reveals the node's listen address (the CLIs print ``Scheduler at:`` /
    ``Worker at:`` exactly for this).
    """

    marker: str = ""

    def __init__(self, extra_env: dict[str, str] | None = None) -> None:
        self.process: asyncio.subprocess.Process | None = None
        self.address: str | None = None
        self.extra_env = dict(extra_env or {})
        self._drain_task: asyncio.Task | None = None

    def _argv(self) -> list[str]:  # pragma: no cover - interface
        raise NotImplementedError

    def _env(self) -> dict[str, str]:
        return child_env(self.extra_env)

    async def start(self, timeout: float = _START_TIMEOUT) -> "ProcessHandle":
        self.process = await asyncio.create_subprocess_exec(
            *self._argv(),
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.STDOUT,
            env=self._env(),
        )
        try:
            self.address = await asyncio.wait_for(
                self._scan_for_marker(), timeout
            )
        except BaseException:
            # a failed start must not orphan the child (it would hold its
            # port forever); __aexit__ never runs for a failed __aenter__
            await self.close()
            raise
        self._drain_task = asyncio.create_task(self._drain())
        return self

    async def _scan_for_marker(self) -> str:
        assert self.process is not None and self.process.stdout is not None
        while True:
            raw = await self.process.stdout.readline()
            if not raw:
                rc = await self.process.wait()
                raise RuntimeError(
                    f"{type(self).__name__} exited rc={rc} before "
                    f"printing {self.marker!r}"
                )
            line = raw.decode(errors="replace").rstrip()
            logger.debug("%s: %s", type(self).__name__, line)
            if line.startswith(self.marker):
                return line.split()[-1]

    async def _drain(self) -> None:
        assert self.process is not None and self.process.stdout is not None
        while True:
            raw = await self.process.stdout.readline()
            if not raw:
                return
            logger.debug(
                "%s: %s", type(self).__name__,
                raw.decode(errors="replace").rstrip(),
            )

    async def finished(self) -> None:
        assert self.process is not None
        await self.process.wait()

    async def close(self, timeout: float = 10.0) -> None:
        proc = self.process
        if proc is None:
            return
        if proc.returncode is None:
            try:
                proc.terminate()
            except ProcessLookupError:
                pass
            try:
                await asyncio.wait_for(proc.wait(), timeout)
            except asyncio.TimeoutError:
                logger.warning(
                    "%s did not exit on SIGTERM; killing", type(self).__name__
                )
                try:
                    proc.kill()
                except ProcessLookupError:
                    pass
                await proc.wait()
        if self._drain_task is not None:
            await self._drain_task
            self._drain_task = None
        # release the pipe transport now: left to GC it may outlive the
        # event loop and warn "Event loop is closed" at interpreter exit
        transport = getattr(proc, "_transport", None)
        if transport is not None:
            transport.close()


class SubprocessScheduler(ProcessHandle):
    """Scheduler in a child process (reference deploy/subprocess.py:115)."""

    marker = "Scheduler at:"

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        protocol: str = "tcp",
        extra_args: Sequence[str] = (),
        extra_env: dict[str, str] | None = None,
        device: Any = None,
    ) -> None:
        super().__init__(extra_env)
        self.host = host
        self.port = port
        self.protocol = protocol
        self.extra_args = list(extra_args)
        self.device = device

    def _argv(self) -> list[str]:
        return [
            sys.executable, "-m", "distributed_tpu_torch.cli.scheduler",
            "--host", self.host,
            "--port", str(self.port),
            "--protocol", self.protocol,
            *device_args(self.device),
            *self.extra_args,
        ]

    async def retire_workers(
        self, workers: list[str] | None = None, **kwargs: Any
    ) -> Any:
        """RPC shim so SpecCluster._correct_state can retire through us."""
        async with rpc(self.address) as r:
            return await r.retire_workers(workers=workers, **kwargs)


class SubprocessWorker(ProcessHandle):
    """Worker (optionally under a nanny) in a child process
    (reference deploy/subprocess.py:61)."""

    marker = "Worker at:"

    def __init__(
        self,
        scheduler_address: str,
        name: object = None,
        nthreads: int = 1,
        nanny: bool = False,
        memory_limit: str | int = "0",
        extra_args: Sequence[str] = (),
        extra_env: dict[str, str] | None = None,
    ) -> None:
        super().__init__(extra_env)
        self.scheduler_address = scheduler_address
        self.name = name
        self.nthreads = nthreads
        self.nanny = nanny
        self.memory_limit = memory_limit
        self.extra_args = list(extra_args)

    @property
    def worker_address(self) -> str | None:
        return self.address

    def _argv(self) -> list[str]:
        argv = [
            sys.executable, "-m", "distributed_tpu_torch.cli.worker",
            self.scheduler_address,
            "--nthreads", str(self.nthreads),
            "--memory-limit", str(self.memory_limit),
        ]
        if self.name is not None:
            argv += ["--name", str(self.name)]
        if self.nanny:
            argv += ["--nanny"]
        argv += self.extra_args
        return argv


class SubprocessCluster(SpecCluster):
    """Local cluster of OS processes (reference deploy/subprocess.py:150).

    ``async with SubprocessCluster(n_workers=2) as cluster`` gives a
    scheduler + workers each in their own process, connected over TCP;
    ``scale``/``Adaptive`` reconcile by spawning/terminating processes.
    """

    def __init__(
        self,
        n_workers: int = 0,
        nthreads: int = 1,
        host: str = "127.0.0.1",
        scheduler_port: int = 0,
        nanny: bool = False,
        memory_limit: str | int = "0",
        worker_options: dict | None = None,
        scheduler_options: dict | None = None,
        adaptive: Any | None = None,
        device: Any = None,
    ) -> None:
        worker_opts = {
            "nthreads": nthreads,
            "nanny": nanny,
            "memory_limit": memory_limit,
            **(worker_options or {}),
        }
        template = {"cls": SubprocessWorker, "options": worker_opts}
        workers = {
            f"worker-{i}": {
                "cls": SubprocessWorker,
                "options": dict(worker_opts),
            }
            for i in range(n_workers)
        }
        super().__init__(
            workers=workers,
            scheduler={
                "cls": SubprocessScheduler,
                "options": {
                    "host": host,
                    "port": scheduler_port,
                    **(scheduler_options or {}),
                },
            },
            worker=template,
            adaptive=adaptive,
            device=device,
        )
