"""LocalCluster: scheduler + workers in one process.

Equivalent of the reference's ``LocalCluster(processes=False)``
(deploy/local.py:23): the scheduler and every worker are Server objects
sharing one event loop, talking over ``inproc://`` comms — the workhorse
for tests and single-host use.  Multi-process workers arrive with the
Nanny (deploy/spec.py equivalent).

The port's copy of ``distributed_tpu/deploy/local.py``, line for line but
for one seam: ``LocalCluster(..., device=None)`` passes ``device`` to its
``Scheduler``, where ``None`` means the CUDA device and raises without
one; only ``device="cpu"`` runs on the CPU.  An explicit
``scheduler_kwargs["device"]`` wins.  (The reference's cluster takes its
scheduler's options only through ``scheduler_kwargs``.)
"""

from __future__ import annotations

import logging
from typing import Any

from distributed_tpu_torch.client.client import Client
from distributed_tpu_torch.scheduler.server import Scheduler
from distributed_tpu_torch.worker.server import Worker

logger = logging.getLogger("distributed_tpu_torch.deploy")


class LocalCluster:
    """In-process cluster (reference deploy/local.py:23)."""

    def __init__(
        self,
        n_workers: int = 2,
        threads_per_worker: int = 1,
        *,
        protocol: str = "inproc",
        security: Any | None = None,
        scheduler_kwargs: dict | None = None,
        worker_kwargs: dict | None = None,
        device: Any = None,
    ):
        self.n_workers = n_workers
        self.threads_per_worker = threads_per_worker
        self.protocol = protocol
        self.security = security
        if protocol == "inproc":
            listen_addr = "inproc://"
        else:
            listen_addr = f"{protocol}://127.0.0.1:0"
        scheduler_kwargs = dict(scheduler_kwargs or {})
        scheduler_kwargs.setdefault("device", device)
        if security is not None:
            scheduler_kwargs.setdefault("security", security)
        self.scheduler = Scheduler(
            listen_addr=listen_addr, **scheduler_kwargs
        )
        self._worker_kwargs = dict(worker_kwargs or {})
        if security is not None:
            self._worker_kwargs.setdefault("security", security)
        self.workers: list[Worker] = []
        self._started = False

    @property
    def scheduler_address(self) -> str:
        return self.scheduler.address

    async def _start(self) -> "LocalCluster":
        if self._started:
            return self
        await self.scheduler.start()
        for i in range(self.n_workers):
            await self.add_worker(name=f"worker-{i}")
        self._started = True
        return self

    async def add_worker(self, name: str | None = None, **kwargs: Any) -> Worker:
        kw = {**self._worker_kwargs, **kwargs}
        kw.setdefault("nthreads", self.threads_per_worker)
        if self.protocol == "inproc":
            kw.setdefault("listen_addr", "inproc://")
        elif self.protocol != "tcp":
            kw.setdefault("listen_addr", f"{self.protocol}://127.0.0.1:0")
        worker = Worker(self.scheduler.address, name=name, **kw)
        await worker.start()
        self.workers.append(worker)
        return worker

    async def scale(self, n: int) -> None:
        """Grow or shrink to ``n`` workers."""
        while len(self.workers) < n:
            await self.add_worker(name=f"worker-{len(self.workers)}")
        if len(self.workers) > n:
            victims = self.workers[n:]
            self.workers = self.workers[:n]
            await self.scheduler.retire_workers(
                workers=[w.address for w in victims]
            )
            for w in victims:
                await w.finished()

    def get_client(self) -> Client:
        return Client(self.scheduler.address, security=self.security)

    async def close(self) -> None:
        # flag shutdown BEFORE workers leave: per-departure recovery
        # (shuffle epoch restarts) is noise once the whole cluster is
        # going away.  A dedicated flag, NOT status=closing — flipping
        # status would stop the comm loop from serving in-flight client
        # RPCs during the drain window
        self.scheduler.draining = True
        for worker in self.workers:
            await worker.close()
        self.workers.clear()
        await self.scheduler.close()

    async def __aenter__(self) -> "LocalCluster":
        return await self._start()

    async def __aexit__(self, *exc: Any) -> None:
        await self.close()

    def __repr__(self) -> str:
        return (
            f"<LocalCluster {len(self.workers)} workers, "
            f"scheduler={self.scheduler!r}>"
        )

    def _repr_html_(self) -> str:
        """Notebook widget (reference jinja2 ``widgets/`` role)."""
        threads = sum(
            getattr(w, "nthreads", 1) for w in self.workers
        )
        dash = getattr(self.scheduler, "dashboard_address", None)
        link = (
            f'<tr><th style="text-align:left">Dashboard</th>'
            f'<td><a href="{dash}">{dash}</a></td></tr>' if dash else ""
        )
        return (
            "<h4 style='margin-bottom:0'>LocalCluster</h4><table>"
            f"<tr><th style='text-align:left'>Scheduler</th>"
            f"<td><tt>{self.scheduler_address}</tt></td></tr>"
            f"<tr><th style='text-align:left'>Workers</th>"
            f"<td>{len(self.workers)}</td></tr>"
            f"<tr><th style='text-align:left'>Threads</th>"
            f"<td>{threads}</td></tr>{link}</table>"
        )
