"""The dispatch gate of the scheduler's device paths, and the counters of
the port's periodic paths.

:func:`device_dispatch_worthwhile` is the port's copy of the reference's
gate (``scheduler/jax_placement.py:127-145``) with its configuration as
explicit parameters, whose defaults are the reference's configuration
defaults (``config.py:63-74``: ``scheduler.jax.enabled`` True,
``min-workers`` 8, ``periodic-min-workers`` 48).  A cycle the gate
routes to the host is the reference's routing, not a fallback.

:func:`config_gate` reads those parameters from the port's configuration
(``distributed_tpu_torch/config.py``, the reference's key names): the
port's own ``WorkStealing`` and ``ReduceReplicas`` gate on it, as the
reference's read theirs.
"""

from __future__ import annotations

ENABLED = True
MIN_WORKERS = 8
PERIODIC_MIN_WORKERS = 48


def config_gate() -> dict:
    """The gate's parameters as the port's configuration holds them now
    (``scheduler.jax.enabled``, ``min-workers``, ``periodic-min-workers``)."""
    from distributed_tpu_torch import config

    return {
        "enabled": bool(config.get("scheduler.jax.enabled")),
        "min_workers": int(config.get("scheduler.jax.min-workers")),
        "periodic_min_workers": int(config.get("scheduler.jax.periodic-min-workers")),
    }


def device_dispatch_worthwhile(n_workers: int, n_items: int, min_items: int,
                               periodic: bool = False, *, enabled: bool = ENABLED,
                               min_workers: int = MIN_WORKERS,
                               periodic_min_workers: int = PERIODIC_MIN_WORKERS) -> bool:
    """The device pays off only with enough workers and enough items to
    amortize a dispatch.  ``periodic``: the caller dispatches every cycle
    (stealing, AMM, rebalance), so it keeps its own, higher worker
    floor."""
    if not enabled:
        return False
    floor = max(min_workers, 2)
    if periodic:
        floor = max(floor, periodic_min_workers)
    return n_workers >= floor and n_items >= min_items


class DevicePath:
    """Counters of one periodic device path of the port: ``launches``
    (plans computed on the path's device), ``failures`` (with the
    exceptions kept in ``errors``), and the cycles the gate sent to the
    device or to the host."""

    def __init__(self, device, *, enabled: bool = ENABLED, min_workers: int = MIN_WORKERS,
                 periodic_min_workers: int = PERIODIC_MIN_WORKERS):
        self.device = device
        self.enabled = enabled
        self.min_workers = min_workers
        self.periodic_min_workers = periodic_min_workers
        self.launches = 0
        self.failures = 0
        self.cycles_device = 0
        self.cycles_host = 0
        self.errors: list[BaseException] = []

    def worthwhile(self, n_workers: int, n_items: int, min_items: int) -> bool:
        return device_dispatch_worthwhile(
            n_workers, n_items, min_items, periodic=True, enabled=self.enabled,
            min_workers=self.min_workers, periodic_min_workers=self.periodic_min_workers,
        )

    def fail(self, exc: BaseException) -> None:
        self.failures += 1
        self.errors.append(exc)

    def counters(self) -> dict[str, int]:
        return {"launches": self.launches, "failures": self.failures,
                "cycles_device": self.cycles_device, "cycles_host": self.cycles_host}

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.counters()} device={self.device}>"
