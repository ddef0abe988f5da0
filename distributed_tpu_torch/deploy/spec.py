"""SpecCluster: declarative cluster from worker specs (reference deploy/spec.py).

A cluster is ``{name: {"cls": WorkerClass, "options": {...}}}`` plus a
scheduler spec.  ``_correct_state`` reconciles desired vs actual workers
(reference deploy/spec.py:346); ``scale`` edits the spec and reconciles.
``Adaptive`` drives ``scale`` from the scheduler's ``adaptive_target``.

The port's copy of ``distributed_tpu/deploy/spec.py``, line for line but
for one seam: ``SpecCluster(..., device=None)`` puts ``device`` into its
scheduler spec's options, where ``None`` means the CUDA device and raises
without one; only ``device="cpu"`` runs on the CPU.  An explicit
``"device"`` in the spec's options wins.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any

from distributed_tpu_torch.client.client import Client
from distributed_tpu_torch.scheduler.server import Scheduler

logger = logging.getLogger("distributed_tpu_torch.deploy")


class Cluster:
    """Base cluster interface (reference deploy/cluster.py:36)."""

    def __init__(self) -> None:
        self.scheduler: Scheduler | None = None

    @property
    def scheduler_address(self) -> str:
        assert self.scheduler is not None
        return self.scheduler.address

    def get_client(self) -> Client:
        return Client(self.scheduler_address)

    async def scale(self, n: int) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    async def _start(self) -> "Cluster":
        raise NotImplementedError

    async def close(self) -> None:
        raise NotImplementedError

    async def __aenter__(self) -> "Cluster":
        return await self._start()

    async def __aexit__(self, *exc: Any) -> None:
        await self.close()


class SpecCluster(Cluster):
    """Cluster described by {name: spec} (reference deploy/spec.py:128)."""

    def __init__(
        self,
        workers: dict[str, dict] | None = None,
        scheduler: dict | None = None,
        worker: dict | None = None,
        adaptive: "Adaptive | None" = None,
        device: Any = None,
    ):
        super().__init__()
        self.worker_spec: dict[str, dict] = dict(workers or {})
        self.scheduler_spec = scheduler or {"cls": Scheduler, "options": {}}
        self.scheduler_spec = {
            **self.scheduler_spec,
            "options": {"device": device, **self.scheduler_spec.get("options", {})},
        }
        self.new_spec = worker or {"cls": None, "options": {}}
        self.workers: dict[str, Any] = {}  # name -> live Worker/Nanny
        self._i = 0
        self._adaptive = adaptive
        self._lock = asyncio.Lock()
        self._started = False

    async def _start(self) -> "SpecCluster":
        if self._started:
            return self
        cls = self.scheduler_spec["cls"]
        self.scheduler = cls(**self.scheduler_spec.get("options", {}))
        await self.scheduler.start()
        await self._correct_state()
        self._started = True
        if self._adaptive is not None:
            self._adaptive.cluster = self
            self._adaptive.start()
        return self

    async def _correct_state(self) -> None:
        """Reconcile live workers with the spec (reference deploy/spec.py:346)."""
        async with self._lock:
            # remove workers no longer in the spec
            to_close = [
                name for name in self.workers if name not in self.worker_spec
            ]

            async def _close_one(name: str) -> None:
                w = self.workers.pop(name)
                addr = getattr(w, "worker_address", None) or getattr(
                    w, "address", None
                )
                if addr is not None and self.scheduler is not None:
                    await self.scheduler.retire_workers(workers=[addr])
                await w.close()

            if to_close:
                results = await asyncio.gather(
                    *(_close_one(n) for n in to_close), return_exceptions=True
                )
                for r in results:
                    if isinstance(r, BaseException):
                        logger.warning("worker close failed: %r", r)

            # start workers in the spec but not yet live — concurrently,
            # so scale(N) pays ~one worker's startup latency
            async def _start_one(name: str, spec: dict) -> None:
                cls = spec["cls"]
                opts = dict(spec.get("options", {}))
                opts.setdefault("name", name)
                worker = cls(self.scheduler.address, **opts)
                await worker.start()
                self.workers[name] = worker

            pending = [
                (n, s) for n, s in self.worker_spec.items()
                if n not in self.workers
            ]
            if pending:
                # return_exceptions: let every sibling settle (and register
                # in self.workers) before re-raising the first failure, so
                # close() sees a complete view and orphans nothing
                results = await asyncio.gather(
                    *(_start_one(n, s) for n, s in pending),
                    return_exceptions=True,
                )
                for r in results:
                    if isinstance(r, BaseException):
                        raise r

    def _new_worker_name(self) -> str:
        while True:
            name = f"worker-{self._i}"
            self._i += 1
            if name not in self.worker_spec:
                return name

    async def scale(self, n: int) -> None:
        """Grow/shrink the spec to n workers, then reconcile
        (reference deploy/spec.py:538)."""
        while len(self.worker_spec) > n:
            self.worker_spec.popitem()
        while len(self.worker_spec) < n:
            if self.new_spec.get("cls") is None:
                raise ValueError("SpecCluster needs a `worker` template to scale up")
            self.worker_spec[self._new_worker_name()] = {
                "cls": self.new_spec["cls"],
                "options": dict(self.new_spec.get("options", {})),
            }
        await self._correct_state()

    async def close(self) -> None:
        if self._adaptive is not None:
            await self._adaptive.astop()
        # take the reconcile lock so no _correct_state is mid-flight
        async with self._lock:
            pass
        for w in list(self.workers.values()):
            await w.close()
        self.workers.clear()
        if self.scheduler is not None:
            await self.scheduler.close()

    def __repr__(self) -> str:
        return (
            f"<{type(self).__name__} workers={sorted(self.workers)} "
            f"spec={sorted(self.worker_spec)}>"
        )


class Adaptive:
    """Scale a cluster from the scheduler's adaptive target
    (reference deploy/adaptive.py:18, adaptive_core.py:26).

    Hysteresis: scale-down requires the same recommendation ``wait_count``
    consecutive intervals (reference distributed.yaml:209-215).
    """

    def __init__(
        self,
        cluster: Cluster | None = None,
        minimum: int | None = None,
        maximum: float | None = None,
        interval: float | None = None,
        wait_count: int | None = None,
        target_duration: float | None = None,
    ):
        from distributed_tpu_torch import config

        self.cluster = cluster
        # config-backed defaults (reference distributed.yaml:209-215
        # adaptive.*): explicit arguments win
        self.minimum = (
            minimum if minimum is not None
            else int(config.get("adaptive.minimum") or 0)
        )
        cfg_max = config.get("adaptive.maximum")
        self.maximum = (
            maximum if maximum is not None
            else (float(cfg_max) if cfg_max not in (None, ".inf", "inf")
                  else float("inf"))
        )
        self.interval = (
            interval if interval is not None
            else config.parse_timedelta(config.get("adaptive.interval") or "1s")
        )
        self.wait_count = (
            wait_count if wait_count is not None
            else int(config.get("adaptive.wait-count") or 3)
        )
        self.target_duration = (
            target_duration if target_duration is not None
            else config.parse_timedelta(
                config.get("adaptive.target-duration") or "5s"
            )
        )
        self._task: asyncio.Task | None = None
        self._rpc: Any | None = None
        self._down_streak = 0
        self.log: list[tuple] = []

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._loop())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def astop(self) -> None:
        """Cancel AND await the adapt task, so no scale is mid-flight when
        the cluster tears down."""
        task = self._task
        self.stop()
        if task is not None:
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
        if self._rpc is not None:
            await self._rpc.close_rpc()
            self._rpc = None

    async def target(self) -> int:
        """Desired worker count, from the scheduler's ``adaptive_target``
        (reference adaptive.py:18 driving scheduler.py:8400 over RPC).

        In-process schedulers (LocalCluster, SpecCluster) are asked
        directly; process-backed ones (SubprocessCluster, SSHCluster)
        over RPC."""
        assert self.cluster is not None and self.cluster.scheduler is not None
        scheduler = self.cluster.scheduler
        if hasattr(scheduler, "state"):
            cpu = scheduler.adaptive_target(
                target_duration=self.target_duration
            )
        else:
            if self._rpc is None:
                from distributed_tpu_torch.rpc.core import rpc

                # one cached connection for the cluster's lifetime: a
                # fresh dial every interval would be a TCP (or full TLS)
                # handshake per second of pure overhead
                self._rpc = rpc(self.cluster.scheduler_address)
            cpu = await self._rpc.adaptive_target(
                target_duration=self.target_duration
            )
        return int(min(max(cpu, self.minimum), self.maximum))

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.interval)
            try:
                await self.adapt()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("adaptive cycle failed")

    async def adapt(self) -> None:
        assert self.cluster is not None
        n_now = len(getattr(self.cluster, "workers", {}))
        n_want = await self.target()
        if n_want > n_now:
            self._down_streak = 0
            self.log.append(("up", n_now, n_want))
            await self.cluster.scale(n_want)
        elif n_want < n_now:
            self._down_streak += 1
            if self._down_streak >= self.wait_count:
                self._down_streak = 0
                self.log.append(("down", n_now, n_want))
                await self.cluster.scale(n_want)
        else:
            self._down_streak = 0
