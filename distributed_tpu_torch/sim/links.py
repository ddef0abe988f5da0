"""Per-edge network model: latency + bandwidth for every simulated link.

The simulator charges every message and every data transfer a virtual
delay computed here.  Profiles come from two places:

- **synthetic**: a uniform ``(latency, bandwidth)`` pair, optionally
  jittered per directed edge with a seeded RNG so the fleet is not
  implausibly homogeneous — deterministic per (seed, src, dst), and
  independent of the order links are first used;
- **measured**: the telemetry plane exports per-link EWMA
  bandwidth/latency (``LinkTelemetry.link_profile()``; full
  ``/telemetry`` JSONL parses too).  ``LinkProfile.from_records`` seeds
  the model with those measured truths, so a simulated policy A/B runs
  over the network your real cluster measured.

Partitions are time-windowed predicates over directed edges — the
chaos layer (sim/chaos.py) installs them; ``reachable`` is consulted at
DELIVERY time, so a partition slicing an in-flight transfer fails it
exactly like a dropped TCP stream.
"""

from __future__ import annotations

import hashlib

DEFAULT_BANDWIDTH = 1e9  # bytes/s — loopback-ish default
DEFAULT_LATENCY = 500e-6  # seconds per message/transfer fixed cost
SCHEDULER = "sim://scheduler"  # the control plane's edge endpoint


class Partition:
    """One network partition: edges crossing between ``side_a`` and
    ``side_b`` are dead for ``t0 <= t < t1`` (both directions)."""

    __slots__ = ("side_a", "side_b", "t0", "t1")

    def __init__(self, side_a, side_b, t0: float, t1: float):
        self.side_a = frozenset(side_a)
        self.side_b = frozenset(side_b)
        self.t0 = float(t0)
        self.t1 = float(t1)

    def cuts(self, src: str, dst: str, t: float) -> bool:
        if not (self.t0 <= t < self.t1):
            return False
        return (src in self.side_a and dst in self.side_b) or (
            src in self.side_b and dst in self.side_a
        )


class LinkProfile:
    """Deterministic per-edge latency/bandwidth."""

    def __init__(
        self,
        bandwidth: float = DEFAULT_BANDWIDTH,
        latency: float = DEFAULT_LATENCY,
        jitter: float = 0.0,
        seed: int = 0,
        overrides: dict[tuple[str, str], tuple[float, float]] | None = None,
    ):
        self.bandwidth = float(bandwidth)
        self.latency = float(latency)
        # +-jitter fraction applied per directed edge, derived from a
        # keyed hash of (seed, src, dst) — NOT from a shared RNG stream,
        # so an edge's character does not depend on which edges happened
        # to be exercised before it
        self.jitter = float(jitter)
        self.seed = int(seed)
        # (src, dst) -> (bandwidth, latency); measured links land here
        self.overrides = dict(overrides or {})
        self.partitions: list[Partition] = []

    @classmethod
    def from_records(cls, records: list[dict], **defaults) -> "LinkProfile":
        """Seed from telemetry link-profile records
        (``LinkTelemetry.link_profile()`` or full ``/telemetry`` JSONL):
        measured links override; unmeasured edges keep the synthetic
        defaults."""
        from distributed_tpu_torch.telemetry import parse_link_profile

        return cls(overrides=parse_link_profile(records), **defaults)

    # ------------------------------------------------------------- edges

    def _edge(self, src: str, dst: str) -> tuple[float, float]:
        ov = self.overrides.get((src, dst))
        if ov is not None:
            return ov
        if not self.jitter:
            return self.bandwidth, self.latency
        h = hashlib.blake2b(
            f"{self.seed}|{src}|{dst}".encode(), digest_size=8
        ).digest()
        u = int.from_bytes(h, "big") / 2**64  # [0, 1)
        f = 1.0 + self.jitter * (2.0 * u - 1.0)
        return self.bandwidth * f, self.latency * f

    def transfer_seconds(self, src: str, dst: str, nbytes: int) -> float:
        """Virtual seconds for a data transfer of ``nbytes`` over the
        directed edge — the same latency + bytes/bandwidth shape the
        scheduler's cost model prices."""
        bw, lat = self._edge(src, dst)
        return lat + nbytes / max(bw, 1.0)

    def control_latency(self, src: str, dst: str) -> float:
        """Virtual seconds for one control-plane payload (stream
        messages both directions)."""
        return self._edge(src, dst)[1]

    # -------------------------------------------------------- partitions

    def add_partition(self, side_a, side_b, t0: float, t1: float) -> None:
        self.partitions.append(Partition(side_a, side_b, t0, t1))

    def reachable(self, src: str, dst: str, t: float) -> bool:
        return not any(p.cuts(src, dst, t) for p in self.partitions)
