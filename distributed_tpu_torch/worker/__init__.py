"""The worker's side of the port: the sans-io state machine, the async
``Worker`` server, and the process-group join and setup."""

from __future__ import annotations


def resolve_lifetime(
    lifetime: float | None,
    stagger: float | None,
    restart: bool | None = None,
) -> tuple[float | None, float, bool]:
    """(duration, stagger, restart): explicit args win, else the
    ``worker.lifetime.*`` config keys (the single place this fallback
    lives — Worker and Nanny both construct from it)."""
    from distributed_tpu_torch import config

    cfg = config.get("worker.lifetime") or {}
    if lifetime is None:
        lifetime = config.parse_timedelta(cfg.get("duration"))
    if stagger is None:
        stagger = config.parse_timedelta(cfg.get("stagger")) or 0
    if restart is None:
        restart = bool(cfg.get("restart"))
    return lifetime, stagger, restart


def sample_lifetime_delay(lifetime: float, stagger: float) -> float:
    """One lifetime deadline with uniform +/- stagger (never below 0.1 s)
    so a fleet doesn't cycle in lock-step."""
    import random

    return max(lifetime + random.uniform(-stagger, stagger), 0.1)
