"""One call that puts the scheduler's periodic device paths on the card.

:func:`install_periodic` takes a running (or about to run) reference
``Scheduler`` and

1. adopts its state's fleet mirror as a
   :class:`~distributed_tpu_torch.scheduler.mirror.TorchMirror` (K6: the
   device view on the card, every slot kept);
2. binds the port's balance cycle onto its ``WorkStealing`` extension
   (K7, ``scheduler/stealing.py``);
3. binds the port's device round onto every ``ReduceReplicas`` policy of
   its Active Memory Manager (K8, ``scheduler/amm.py``);
4. sets the port's rebalance plan on the scheduler (K9,
   ``scheduler/rebalance.py``).

It returns a :class:`PeriodicHandle` whose paths count ``launches``,
``failures``, ``cycles_device`` and ``cycles_host``.  Usage, with a
``LocalCluster`` (``cluster.scheduler`` is the scheduler)::

    handle = install_periodic(cluster.scheduler)            # on the card
    handle = install_periodic(cluster.scheduler, device="cpu",
                              min_workers=0, periodic_min_workers=0)

The gate's parameters default to the reference's configuration
(``gate.py``); ``device=None`` means CUDA and raises without one.
"""

from __future__ import annotations

from dataclasses import dataclass

from distributed_tpu_torch._device import resolve_device
from distributed_tpu_torch.scheduler.amm import AmmPath, install_amm
from distributed_tpu_torch.scheduler.mirror import TorchMirror
from distributed_tpu_torch.scheduler.rebalance import RebalancePath, install_rebalance
from distributed_tpu_torch.scheduler.stealing import (
    StealingPath,
    ensure_mirror,
    install_stealing,
)


@dataclass
class PeriodicHandle:
    """What :func:`install_periodic` installed (None where the scheduler
    has no such extension or mirror)."""

    mirror: TorchMirror | None
    stealing: StealingPath | None
    amm: AmmPath | None
    rebalance: RebalancePath

    @property
    def paths(self) -> dict:
        return {name: p for name, p in (("stealing", self.stealing), ("amm", self.amm),
                                         ("rebalance", self.rebalance)) if p is not None}

    @property
    def failures(self) -> int:
        return sum(p.failures for p in self.paths.values())


def _reduce_replicas(amm) -> list:
    """The manager's ReduceReplicas policies (duck-typed: the port does
    not import the reference's class)."""
    return [p for p in amm.policies if hasattr(p, "_run_device") and hasattr(p, "_desired")]


def install_periodic(scheduler, device=None, **gate) -> PeriodicHandle:
    """Install the port's periodic device paths on ``scheduler``; ``gate``
    holds ``enabled``, ``min_workers`` and ``periodic_min_workers`` for
    stealing and AMM (rebalance keeps the scheduler's own gate)."""
    dev = resolve_device(device)
    mirror = ensure_mirror(scheduler.state, dev)
    ext = scheduler.extensions.get("stealing")
    stealing = install_stealing(ext, dev, **gate) if ext is not None else None
    amm_ext = scheduler.extensions.get("amm")
    amm = None
    if amm_ext is not None:
        policies = _reduce_replicas(amm_ext)
        if policies:
            amm = AmmPath(dev, **gate)
            for policy in policies:
                install_amm(policy, path=amm)
    rebalance = install_rebalance(scheduler, dev)
    return PeriodicHandle(mirror=mirror, stealing=stealing, amm=amm, rebalance=rebalance)
