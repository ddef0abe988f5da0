"""Measured-truth telemetry plane: per-link transfer stats, task-prefix
priors, and the shadow cost-model divergence monitor.

ROADMAP item 3's standing indictment is that the static
``scheduler.bandwidth`` constant (config.py) was measured ~10x wrong
(PERF.md Round 4) while the cluster already measures the truth and
throws it away as unattributed global sums.  This module is the
*measurement* half of the fix — a strictly read-only observability
layer:

- **per-link transfer telemetry**: every ``get_data``/``gather_dep``
  transfer files ``(src, dst, nbytes, seconds)`` on both ends (the
  requesting end's sample is the authoritative bandwidth — it observes
  the full fetch the cost model prices; the serving end's true-wire
  bytes are the cross-check), folded into per-link EWMA bandwidth /
  latency plus native t-digests (``native/tdigest.cpp`` via
  ``utils.counter.Digest``) and shipped to the scheduler as heartbeat
  deltas next to the span fine-metrics;
- **per-task-prefix priors**: EWMA duration and output-nbytes per task
  prefix, aggregated scheduler-side from the same heartbeat stream
  (the worker's per-task ``execute`` fine-metric rows);
- **shadow cost-model divergence**: at each placement decision and
  steal pricing the scheduler computes the measured-model comm cost
  next to the constant model (same ``get_comm_cost`` shape, measured
  link bandwidth with constant fallback for unseen links) and records
  ``measured / constant`` in the ``dtpu_costmodel_divergence_ratio``
  histogram plus a sampled flight-recorder ``shadow`` event carrying
  the stimulus id — so Perfetto shows *which decisions the constants
  are lying about*.  **Decisions still use the constants**: swapping
  the kernel inputs is ROADMAP item 3's future PR, and a property test
  asserts bit-identical decisions with telemetry on/off.

Exposed via ``/metrics`` (per-link gauges, priors, the divergence
histogram), the ``/telemetry`` JSONL route on both roles, cluster
dumps, and Perfetto counter tracks (docs/observability.md).

This file is pure (no IO, no event loop, no threads of its own): both
roles' servers import it, and the monotonic-time lint covers it — the
snapshot timestamp is ``utils.misc.time`` (monotonic), so telemetry
records line up with flight-recorder events on one clock.
"""

from __future__ import annotations

from typing import Any

from distributed_tpu_torch import config
from distributed_tpu_torch.utils import time

#: schema version of /telemetry JSONL records (bump on field changes)
TELEMETRY_SCHEMA_VERSION = 1

#: divergence-ratio histogram layout (measured / constant cost): dense
#: around 1.0 (agreement), decades out to the ~10x-off regime Round 4
#: measured and beyond
RATIO_BUCKETS = (
    0.01, 0.03, 0.1, 0.2, 0.33, 0.5, 0.8, 1.0, 1.25, 2.0, 3.0, 5.0,
    10.0, 30.0, 100.0,
)

#: ratios are clamped here before observation: a zero constant cost
#: against a nonzero measured one is "infinitely" divergent, and +inf
#: would poison the histogram sum
RATIO_CLAMP = 1e6


class EWMA:
    """Exponentially weighted moving average with a weight-aware update
    (a heartbeat row aggregating N samples applies the N-fold decay in
    one step: ``alpha_eff = 1 - (1-alpha)**N``)."""

    __slots__ = ("alpha", "value", "count")

    def __init__(self, alpha: float):
        self.alpha = alpha
        self.value = 0.0
        self.count = 0

    def update(self, sample: float, weight: int = 1) -> None:
        if weight <= 0:
            return
        if self.count == 0:
            self.value = sample
        else:
            a = 1.0 - (1.0 - self.alpha) ** weight
            self.value += a * (sample - self.value)
        self.count += weight


class LinkStats:
    """One directed link (src worker -> dst worker).

    ``bandwidth``/``latency`` EWMAs and the t-digest fold only
    destination-observed samples (the full fetch the cost model
    prices); ``peer_*`` totals accumulate the serving end's true-wire
    bytes as the framing-overhead cross-check (docs/observability.md).
    """

    __slots__ = ("src", "dst", "bandwidth", "latency", "bytes_total",
                 "seconds_total", "digest", "peer_bytes", "peer_seconds",
                 "peer_count")

    def __init__(self, src: str, dst: str, alpha: float):
        self.src = src
        self.dst = dst
        self.bandwidth = EWMA(alpha)   # bytes/second
        self.latency = EWMA(alpha)     # residual seconds past bytes/bw
        self.bytes_total = 0
        self.seconds_total = 0.0
        self.digest: Any = None        # lazy Digest of per-sample bytes/s
        self.peer_bytes = 0            # serving-end-reported wire bytes
        self.peer_seconds = 0.0
        self.peer_count = 0

    def fold(self, nbytes: int, seconds: float, count: int = 1) -> None:
        """Fold one destination-observed sample (or a heartbeat row
        aggregating ``count`` of them)."""
        if seconds <= 0.0:
            seconds = 1e-9
        bw = nbytes / seconds
        self.bandwidth.update(bw, count)
        # residual latency: observed seconds minus the pure-transfer
        # time at the current bandwidth estimate — a crude but
        # monotone-clock-honest per-link fixed-cost estimate (count>1
        # rows average the residual over the row)
        per = seconds / count
        resid = per - (nbytes / count) / max(self.bandwidth.value, 1e-9)
        self.latency.update(max(resid, 0.0), count)
        self.bytes_total += int(nbytes)
        self.seconds_total += seconds
        if self.digest is None:
            from distributed_tpu_torch.utils.counter import Digest

            self.digest = Digest()
        self.digest.add(bw, float(count))

    def fold_peer(self, nbytes: int, seconds: float, count: int = 1) -> None:
        """Fold a source-reported (serving-end) row: cross-check totals
        only — the serving end's clock never sees the request leg, so
        its bandwidth view must not dilute the destination EWMA."""
        self.peer_bytes += int(nbytes)
        self.peer_seconds += seconds
        self.peer_count += count

    def record(self) -> dict:
        out = {
            "v": TELEMETRY_SCHEMA_VERSION,
            "type": "link",
            "src": self.src,
            "dst": self.dst,
            "bandwidth": self.bandwidth.value,
            "latency": self.latency.value,
            "count": self.bandwidth.count,
            "bytes": self.bytes_total,
            "seconds": self.seconds_total,
            "peer_bytes": self.peer_bytes,
            "peer_seconds": self.peer_seconds,
            "peer_count": self.peer_count,
        }
        if self.digest is not None and self.digest.count():
            out["bw_q50"] = self.digest.quantile(0.5)
            out["bw_q90"] = self.digest.quantile(0.9)
            out["bw_q99"] = self.digest.quantile(0.99)
        return out


def parse_link_profile(records: list[dict]) -> dict[tuple[str, str], tuple[float, float]]:
    """Parse link-profile (or full ``/telemetry``) records into
    ``{(src, dst): (bandwidth_bytes_per_s, latency_s)}`` — the seedable
    form the simulator's ``LinkProfile`` consumes.  Rows that are not
    ``type == "link"`` or carry no measured bandwidth are skipped."""
    out: dict[tuple[str, str], tuple[float, float]] = {}
    for rec in records:
        if rec.get("type") != "link":
            continue
        bw = float(rec.get("bandwidth") or 0.0)
        if bw <= 0.0:
            continue
        out[(str(rec.get("src", "")), str(rec.get("dst", "")))] = (
            bw, max(float(rec.get("latency") or 0.0), 0.0)
        )
    return out


class PrefixPrior:
    """Measured per-task-prefix priors: EWMA duration and output bytes
    (the measured twin of ``TaskPrefix.duration_average`` /
    ``UNKNOWN_TASK_DURATION``, fed from realized executions)."""

    __slots__ = ("name", "duration", "nbytes", "n_tasks")

    def __init__(self, name: str, alpha: float):
        self.name = name
        self.duration = EWMA(alpha)
        self.nbytes = EWMA(alpha)
        self.n_tasks = 0

    def record(self) -> dict:
        return {
            "v": TELEMETRY_SCHEMA_VERSION,
            "type": "prior",
            "prefix": self.name,
            "duration": self.duration.value,
            "nbytes": self.nbytes.value,
            "n_tasks": self.n_tasks,
        }


class LinkTelemetry:
    """Per-node transfer-telemetry collector.

    Workers record transfers as they happen (``record``); the
    since-heartbeat delta buffer (``take``/``restore``/``rows``, the
    ``FineMetrics`` idiom) ships per-link aggregates to the scheduler,
    whose :class:`ClusterTelemetry` folds them fleet-wide.
    """

    def __init__(self, alpha: float | None = None,
                 enabled: bool | None = None):
        if alpha is None:
            alpha = float(config.get("scheduler.telemetry.ewma-alpha"))
        if enabled is None:
            enabled = bool(config.get("scheduler.telemetry.enabled"))
        self.alpha = alpha
        self.enabled = bool(enabled)
        # injectable clock (ROADMAP item 1 simulator): snapshots are the
        # only place this collector stamps time — the fold path takes
        # ``seconds`` as data, never reads a clock — so re-pointing this
        # at a VirtualClock keeps simulated-transfer EWMAs and their
        # /telemetry records entirely on virtual time.
        self.clock = time
        # deferred-materialization barrier: the scheduler's native
        # engine points this at its sync() so a live transfer record
        # lands AFTER any parked shadow-cost folds replay (ordering of
        # EWMA folds is observable in divergence telemetry).  The folds
        # that run DURING replay (shadow_comm_cost, join_row realized
        # costs) enter below the barrier, so replay never re-enters it.
        self.barrier: Any = None
        self.links: dict[tuple[str, str], LinkStats] = {}
        # since-heartbeat delta: (src, dst) -> [nbytes, seconds, count]
        self.since_heartbeat: dict[tuple[str, str], list] = {}

    def _link(self, src: str, dst: str) -> LinkStats:
        link = self.links.get((src, dst))
        if link is None:
            link = self.links[(src, dst)] = LinkStats(src, dst, self.alpha)
        return link

    def record(self, src: str, dst: str, nbytes: int,
               seconds: float) -> None:
        """File one transfer observed at its DESTINATION (the
        authoritative bandwidth sample: the full fetch the cost model
        prices)."""
        b = self.barrier
        if b is not None:
            b()
        if not self.enabled or not src or not dst:
            return
        self._link(src, dst).fold(nbytes, seconds)
        self._delta(src, dst, nbytes, seconds)

    def record_peer(self, src: str, dst: str, nbytes: int,
                    seconds: float) -> None:
        """File one transfer observed at its SOURCE (the get_data
        serving end): cross-check totals only, locally AND in the
        shipped delta — the serving clock stops when the OS accepts the
        write, not when the peer received the bytes, so this view must
        never fold into the dst-observed bandwidth EWMA (the scheduler
        re-classifies shipped rows by reporter; the local collector
        splits here)."""
        b = self.barrier
        if b is not None:
            b()
        if not self.enabled or not src or not dst:
            return
        self._link(src, dst).fold_peer(nbytes, seconds)
        self._delta(src, dst, nbytes, seconds)

    def _delta(self, src: str, dst: str, nbytes: int,
               seconds: float) -> None:
        d = self.since_heartbeat.get((src, dst))
        if d is None:
            self.since_heartbeat[(src, dst)] = [int(nbytes), seconds, 1]
        else:
            d[0] += int(nbytes)
            d[1] += seconds
            d[2] += 1

    # --------------------------------------------------- heartbeat delta

    def take(self) -> dict[tuple[str, str], list]:
        """Pop the heartbeat delta; pair with restore() on send failure."""
        out = self.since_heartbeat
        self.since_heartbeat = {}
        return out

    def restore(self, delta: dict[tuple[str, str], list]) -> None:
        for k, (nbytes, seconds, count) in delta.items():
            d = self.since_heartbeat.get(k)
            if d is None:
                self.since_heartbeat[k] = [nbytes, seconds, count]
            else:
                d[0] += nbytes
                d[1] += seconds
                d[2] += count

    @staticmethod
    def rows(delta: dict[tuple[str, str], list]) -> list[list]:
        """msgpack-friendly encoding: [src, dst, nbytes, seconds, count]."""
        return [[src, dst, *vals] for (src, dst), vals in delta.items()]

    def fold_rows(self, rows: list, reporter: str = "") -> None:
        """Fold heartbeat delta rows into the fleet view.

        ``reporter`` is the worker that shipped them: rows it reports as
        the transfer *destination* are authoritative bandwidth samples;
        rows it reports as the *source* (get_data serving end) fold into
        the cross-check totals only.
        """
        for row in rows:
            try:
                src, dst, nbytes, seconds, count = row
            except (TypeError, ValueError):
                continue
            link = self._link(src, dst)
            if reporter and reporter == src and src != dst:
                link.fold_peer(nbytes, seconds, count)
            else:
                link.fold(nbytes, seconds, max(int(count), 1))

    # ---------------------------------------------------------- snapshot

    def snapshot(self, now: float | None = None) -> list[dict]:
        """JSON-safe records for ``/telemetry`` and cluster dumps.  One
        monotonic ``ts`` per snapshot so records line up with
        flight-recorder events on the same in-process clock."""
        if now is None:
            now = self.clock()
        out = []
        for link in self.links.values():
            rec = link.record()
            rec["ts"] = now
            out.append(rec)
        return out

    # ------------------------------------------------------ link profiles

    def link_profile(self) -> list[dict]:
        """Export the measured per-link state as a *link profile*: the
        minimal ``{src, dst, bandwidth, latency, count}`` rows the
        ROADMAP item 1 simulator seeds its network model from
        (``distributed_tpu_torch.sim.links.LinkProfile.from_records``).  Full
        ``/telemetry`` link records parse too — this export just strips
        the cross-check totals and digest quantiles a simulation cannot
        use."""
        out = []
        for link in self.links.values():
            if not link.bandwidth.count:
                continue
            out.append({
                "v": TELEMETRY_SCHEMA_VERSION,
                "type": "link",
                "src": link.src,
                "dst": link.dst,
                "bandwidth": link.bandwidth.value,
                "latency": link.latency.value,
                "count": link.bandwidth.count,
            })
        return out


class ClusterTelemetry(LinkTelemetry):
    """The scheduler's fleet-wide aggregate: links (folded from worker
    heartbeats) + per-worker heartbeat RTT + task-prefix priors + the
    shadow cost-model divergence monitor."""

    def __init__(self, alpha: float | None = None,
                 enabled: bool | None = None):
        super().__init__(alpha=alpha, enabled=enabled)
        from distributed_tpu_torch.tracing import Histogram

        self.rtt: dict[str, float] = {}       # worker -> EWMA seconds
        self.priors: dict[str, PrefixPrior] = {}
        self.hist_divergence = Histogram(RATIO_BUCKETS)
        self.divergence_sample = max(
            int(config.get("scheduler.telemetry.divergence-sample")), 1
        )
        self._div_tick = 0
        self.shadow_evals = 0        # shadow cost evaluations performed
        self.shadow_measured = 0     # evals where >=1 measured link priced
        # extremes over MEASURED evals; None until one happens (a 1.0
        # initializer would report a never-observed perfect agreement)
        self.ratio_min: float | None = None
        self.ratio_max: float | None = None

    # --------------------------------------------------------------- rtt

    def record_rtt(self, worker: str, rtt: float) -> None:
        """Store a worker's heartbeat round-trip EWMA (measured at the
        worker with monotonic stamps around the heartbeat RPC)."""
        if rtt > 0.0:
            self.rtt[worker] = rtt

    def forget_worker(self, worker: str) -> None:
        """Drop a removed worker's RTT and every link touching it —
        restarted workers bind fresh ports, so dead-address LinkStats
        (each holding a native t-digest) would otherwise accumulate
        forever and crowd live links out of the /metrics top-N cut."""
        self.rtt.pop(worker, None)
        for key in [k for k in self.links if worker in k]:
            del self.links[key]

    # ------------------------------------------------------------ priors

    def fold_fine_rows(self, rows: list) -> None:
        """Derive per-prefix priors from one heartbeat's fine-metric
        rows (``[context, span_id, prefix, label, unit, value]``): the
        worker files per-task ``compute``/``output``/``count`` samples
        under the ``execute`` context, and each heartbeat's per-prefix
        mean folds in as one count-weighted EWMA step."""
        agg: dict[str, list] = {}  # prefix -> [seconds, bytes, count]
        for row in rows:
            try:
                context, _sid, prefix, label, _unit, value = row
            except (TypeError, ValueError):
                continue
            if context != "execute" or not prefix:
                continue
            a = agg.get(prefix)
            if a is None:
                a = agg[prefix] = [0.0, 0.0, 0]
            if label == "compute":
                a[0] += value
            elif label == "output":
                a[1] += value
            elif label == "count":
                a[2] += int(value)
        for prefix, (seconds, nbytes, count) in agg.items():
            if count <= 0:
                continue
            prior = self.priors.get(prefix)
            if prior is None:
                prior = self.priors[prefix] = PrefixPrior(prefix, self.alpha)
            prior.duration.update(seconds / count, count)
            prior.nbytes.update(nbytes / count, count)
            prior.n_tasks += count

    # ------------------------------------------------- shadow divergence

    def tick_divergence(self) -> bool:
        """1-in-N sampling gate for shadow evaluations
        (``scheduler.telemetry.divergence-sample``)."""
        t = self._div_tick + 1
        self._div_tick = t
        return not t % self.divergence_sample

    def observe_divergence(self, constant: float, measured: float,
                           used_measured: bool) -> float:
        """Record one shadow comparison; returns the (clamped) ratio.

        Strictly read-only with respect to scheduling: nothing here is
        ever consulted by a decision path.
        """
        if constant > 1e-12:
            ratio = min(measured / constant, RATIO_CLAMP)
        else:
            ratio = 1.0 if measured <= 1e-12 else RATIO_CLAMP
        self.hist_divergence.observe(ratio)
        self.shadow_evals += 1
        if used_measured:
            self.shadow_measured += 1
            if self.ratio_min is None or ratio < self.ratio_min:
                self.ratio_min = ratio
            if self.ratio_max is None or ratio > self.ratio_max:
                self.ratio_max = ratio
        return ratio

    # ---------------------------------------------------------- snapshot

    def snapshot(self, now: float | None = None) -> list[dict]:
        if now is None:
            now = self.clock()
        out = super().snapshot(now)
        for worker, rtt in self.rtt.items():
            out.append({
                "v": TELEMETRY_SCHEMA_VERSION,
                "type": "rtt",
                "ts": now,
                "worker": worker,
                "rtt": rtt,
            })
        for prior in self.priors.values():
            rec = prior.record()
            rec["ts"] = now
            out.append(rec)
        h = self.hist_divergence
        out.append({
            "v": TELEMETRY_SCHEMA_VERSION,
            "type": "divergence",
            "ts": now,
            "count": h.count,
            "sum": h.sum,
            "evals": self.shadow_evals,
            "measured": self.shadow_measured,
            "ratio_min": self.ratio_min,
            "ratio_max": self.ratio_max,
        })
        return out
