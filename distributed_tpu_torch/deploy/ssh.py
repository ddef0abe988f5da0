"""SSH cluster: scheduler and workers launched on remote hosts over ssh.

Fills the reference's ``deploy/ssh.py`` role.  Where the reference drives
asyncssh connections, we drive the system ``ssh`` binary (zero extra
dependencies; respects the operator's ~/.ssh config, agents, jump hosts),
reusing the `ProcessHandle` machinery from deploy/subprocess.py — an ssh
launch is just a subprocess whose argv is ``ssh <host> '<remote cmd>'``.

Assumptions (same as the reference): ``distributed_tpu_torch`` is importable by
``remote_python`` on every host, and hosts can reach each other's TCP
ports.  The first host runs the scheduler, the rest run workers
(reference deploy/ssh.py:380 ``SSHCluster(["host1", "host2", ...])``).

``connect_command`` is injectable so tests can substitute a local shell
for a real ssh client and still exercise the full command-construction
and address-discovery path.

The port's copy of ``distributed_tpu/deploy/ssh.py``, line for line but
for the device: the remote nodes run ``-m distributed_tpu_torch.cli.*``,
and ``SSHCluster(..., device=None)`` reaches ``SSHScheduler`` as
``--device`` (``deploy/subprocess.py``'s seam).
"""

from __future__ import annotations

import logging
import shlex
import sys
from typing import Any, Sequence

from distributed_tpu_torch.deploy.spec import SpecCluster
from distributed_tpu_torch.deploy.subprocess import (
    ProcessHandle,
    SubprocessScheduler,
    device_args,
)

logger = logging.getLogger("distributed_tpu_torch.deploy")


class SSHProcess(ProcessHandle):
    """A node on a remote host, launched as ``ssh <host> '<command>'``."""

    def __init__(
        self,
        host: str,
        connect_command: Sequence[str] = ("ssh",),
        remote_python: str = sys.executable,
        env_vars: dict[str, str] | None = None,
    ) -> None:
        super().__init__()
        self.host = host
        self.connect_command = list(connect_command)
        self.remote_python = remote_python
        self.env_vars = dict(env_vars or {})

    def _remote_argv(self) -> list[str]:  # pragma: no cover - interface
        raise NotImplementedError

    def _argv(self) -> list[str]:
        exports = " ".join(
            f"{k}={shlex.quote(v)}" for k, v in self.env_vars.items()
        )
        cmd = " ".join(shlex.quote(p) for p in self._remote_argv())
        remote = f"{exports} {cmd}" if exports else cmd
        return [*self.connect_command, self.host, remote]


class SSHScheduler(SSHProcess):
    """Scheduler on ``host``, bound to all interfaces, advertised as
    ``tcp://<host>:<port>`` so workers on other machines can reach it."""

    marker = "Scheduler at:"

    def __init__(
        self,
        host: str,
        port: int = 0,
        bind_host: str = "0.0.0.0",
        contact_host: str | None = None,
        extra_args: Sequence[str] = (),
        device: Any = None,
        **ssh_kwargs: Any,
    ) -> None:
        super().__init__(host, **ssh_kwargs)
        self.device = device
        self.port = port
        self.bind_host = bind_host
        # the name workers dial: the ssh destination minus any user@
        # prefix by default; pass contact_host when the ssh destination
        # is a ~/.ssh/config alias other machines cannot resolve
        self.contact_host = contact_host or host.rpartition("@")[2]
        self.extra_args = list(extra_args)

    def _remote_argv(self) -> list[str]:
        return [
            self.remote_python, "-m", "distributed_tpu_torch.cli.scheduler",
            "--host", self.bind_host,
            "--port", str(self.port),
            *device_args(self.device),
            *self.extra_args,
        ]

    async def start(self, timeout: float = 60.0) -> "SSHScheduler":
        await super().start(timeout)
        # the remote printed its BIND address (e.g. tcp://0.0.0.0:p);
        # rewrite to the address peers should dial
        assert self.address is not None
        proto, _, rest = self.address.partition("://")
        port = rest.rsplit(":", 1)[-1]
        self.address = f"{proto}://{self.contact_host}:{port}"
        return self

    # SpecCluster._correct_state retires through the scheduler handle
    retire_workers = SubprocessScheduler.retire_workers


class SSHWorker(SSHProcess):
    """Worker on ``host`` dialing a remote scheduler."""

    marker = "Worker at:"

    def __init__(
        self,
        scheduler_address: str,
        host: str = "",
        name: object = None,
        nthreads: int = 1,
        nanny: bool = False,
        memory_limit: str | int = "0",
        bind_host: str = "auto",
        extra_args: Sequence[str] = (),
        **ssh_kwargs: Any,
    ) -> None:
        super().__init__(host, **ssh_kwargs)
        self.scheduler_address = scheduler_address
        self.name = name
        self.nthreads = nthreads
        self.nanny = nanny
        self.memory_limit = memory_limit
        self.bind_host = bind_host
        self.extra_args = list(extra_args)

    @property
    def worker_address(self) -> str | None:
        return self.address

    def _remote_argv(self) -> list[str]:
        argv = [
            self.remote_python, "-m", "distributed_tpu_torch.cli.worker",
            self.scheduler_address,
            "--nthreads", str(self.nthreads),
            "--memory-limit", str(self.memory_limit),
            # bind a cross-host-reachable interface, not loopback.  The
            # default "auto" binds whatever interface routes to the
            # scheduler — correct even when the ssh destination is a
            # ~/.ssh/config alias the worker machine itself can't resolve
            "--host", self.bind_host,
        ]
        if self.name is not None:
            argv += ["--name", str(self.name)]
        if self.nanny:
            argv += ["--nanny"]
        argv += self.extra_args
        return argv


class SSHCluster(SpecCluster):
    """Cluster over ssh: ``hosts[0]`` runs the scheduler, ``hosts[1:]``
    run one worker each (reference deploy/ssh.py:380).

    ``SSHCluster(["gateway", "node1", "node2"])`` brings up a 2-worker
    cluster; ``scale(n)`` round-robins new workers over the worker hosts.
    """

    def __init__(
        self,
        hosts: Sequence[str],
        connect_command: Sequence[str] = ("ssh",),
        remote_python: str = sys.executable,
        env_vars: dict[str, str] | None = None,
        nthreads: int = 1,
        nanny: bool = False,
        memory_limit: str | int = "0",
        scheduler_options: dict | None = None,
        worker_options: dict | None = None,
        adaptive: Any | None = None,
        device: Any = None,
    ) -> None:
        if len(hosts) < 2:
            raise ValueError(
                "SSHCluster needs >= 2 hosts: [scheduler, worker, ...]"
            )
        self.hosts = list(hosts)
        ssh_kwargs = {
            "connect_command": list(connect_command),
            "remote_python": remote_python,
            "env_vars": dict(env_vars or {}),
        }
        self._ssh_kwargs = ssh_kwargs
        worker_hosts = self.hosts[1:]
        base_worker = {
            "nthreads": nthreads,
            "nanny": nanny,
            "memory_limit": memory_limit,
            **(worker_options or {}),
            **ssh_kwargs,
        }
        workers = {
            f"{host}-{i}": {
                "cls": SSHWorker,
                "options": {**base_worker, "host": host},
            }
            for i, host in enumerate(worker_hosts)
        }
        # template for scale(): round-robin over worker hosts
        self._worker_hosts = worker_hosts
        super().__init__(
            workers=workers,
            scheduler={
                "cls": SSHScheduler,
                "options": {
                    "host": self.hosts[0],
                    **(scheduler_options or {}),
                    **ssh_kwargs,
                },
            },
            worker={"cls": SSHWorker, "options": dict(base_worker)},
            adaptive=adaptive,
            device=device,
        )

    async def scale(self, n: int) -> None:
        """Grow/shrink like SpecCluster.scale, pinning each new spec to a
        concrete host (round-robin over the worker hosts)."""
        while len(self.worker_spec) > n:
            self.worker_spec.popitem()
        while len(self.worker_spec) < n:
            name = self._new_worker_name()
            host = self._worker_hosts[self._i % len(self._worker_hosts)]
            self.worker_spec[name] = {
                "cls": SSHWorker,
                "options": {**self.new_spec["options"], "host": host},
            }
        await self._correct_state()
