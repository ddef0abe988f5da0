"""Minimal asyncio HTTP server for observability routes (reference http/).

The reference mounts tornado route tables on every ServerNode
(node.py, http/scheduler/*, http/worker/*); here a small asyncio
handler serves the same surface without a web-framework dependency:

- /health                    liveness probe (reference http/health.py:6)
- /info                      identity JSON
- /metrics                   Prometheus text exposition
  (reference http/scheduler/prometheus/core.py, http/worker/prometheus/)
- /json/counts.json          scheduler state counts (reference http/scheduler/json.py)
- /sysmon                    SystemMonitor ring buffers

The port's copy of ``distributed_tpu/http/server.py``, line for line but
for ``dtpu_build_info`` (``:349-396`` there): its labels come from the
port's ``http/build_info.py`` (torch, CUDA, backend, card), on the
scheduler's device or, on a worker, on :func:`process_device`.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Any, Callable

logger = logging.getLogger("distributed_tpu_torch.http")


class HTTPServer:
    """Tiny HTTP/1.0 route server bound next to a Server's comm listener."""

    def __init__(self, routes: dict[str, Callable[[], Any]], host: str = "127.0.0.1",
                 port: int = 0):
        self.routes = routes
        self.host = host
        self.requested_port = port
        self._server: asyncio.AbstractServer | None = None

    @property
    def port(self) -> int:
        assert self._server is not None
        return self._server.sockets[0].getsockname()[1]

    async def start(self) -> "HTTPServer":
        self._server = await asyncio.start_server(
            self._handle, self.host, self.requested_port
        )
        return self

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            request_line = await asyncio.wait_for(reader.readline(), 5)
            parts = request_line.decode("latin1").split()
            if len(parts) < 2:
                return
            path = parts[1].split("?")[0]
            # drain headers
            while True:
                line = await asyncio.wait_for(reader.readline(), 5)
                if line in (b"\r\n", b"\n", b""):
                    break
            handler = self.routes.get(path)
            if handler is None:
                # parameterized routes: "/prefix/{rest}" entries receive
                # the remainder of the path as their single argument
                # (the per-worker proxy role, reference http/proxy.py:147)
                for route, fn in self.routes.items():
                    if not route.endswith("/{rest}"):
                        continue
                    prefix = route[: -len("/{rest}")]
                    if path == prefix or path.startswith(prefix + "/"):
                        rest = path[len(prefix) + 1:]
                        handler = (lambda fn=fn, rest=rest: fn(rest))
                        break
            if handler is None:
                body = b"not found"
                status, ctype = "404 Not Found", "text/plain"
            else:
                try:
                    result = handler()
                    if asyncio.iscoroutine(result):
                        result = await result
                    status = "200 OK"
                    if isinstance(result, tuple) and len(result) == 3:
                        # (body, content_type, status) — error pages
                        # must carry real HTTP codes, not 200-JSON
                        body, ctype, status = result
                        if isinstance(body, (dict, list)):
                            body = json.dumps(body, default=str)
                        if isinstance(body, str):
                            body = body.encode()
                    elif isinstance(result, tuple) and len(result) == 2:
                        # (body, content_type) for non-default types
                        body, ctype = result
                        if isinstance(body, str):
                            body = body.encode()
                    elif isinstance(result, (dict, list)):
                        body = json.dumps(result, default=str).encode()
                        ctype = "application/json"
                    elif isinstance(result, bytes):
                        body = result
                        ctype = "text/plain; version=0.0.4"
                    else:
                        body = str(result).encode()
                        ctype = "text/plain"
                except Exception as e:
                    logger.exception("http handler %s failed", path)
                    body = f"error: {e}".encode()
                    status, ctype = "500 Internal Server Error", "text/plain"
            writer.write(
                (
                    f"HTTP/1.0 {status}\r\n"
                    f"Content-Type: {ctype}\r\n"
                    f"Content-Length: {len(body)}\r\n"
                    "\r\n"
                ).encode()
                + body
            )
            await writer.drain()
        except (asyncio.TimeoutError, ConnectionError):
            pass
        finally:
            try:
                writer.close()
            # graft-lint: allow[swallowed-exceptions] best-effort socket close after reply
            except Exception:
                pass


# ----------------------------------------------------- prometheus helpers

def prom_line(name: str, value: float, labels: dict | None = None,
              help_: str | None = None, type_: str = "gauge") -> str:
    out = []
    if help_:
        out.append(f"# HELP {name} {help_}")
        out.append(f"# TYPE {name} {type_}")
    if labels:
        lab = ",".join(f'{k}="{v}"' for k, v in labels.items())
        out.append(f"{name}{{{lab}}} {value}")
    else:
        out.append(f"{name} {value}")
    return "\n".join(out)


def prom_histogram_lines(name: str, hist: Any,
                         help_: str | None = None,
                         labels: dict | None = None) -> list[str]:
    """Prometheus histogram exposition for a ``tracing.Histogram``:
    cumulative ``le`` buckets + ``_sum`` + ``_count``, p50/p99-capable
    via ``histogram_quantile`` in any Prometheus UI.  ``labels`` (e.g.
    the ledger's ``kind``/``model``) merge into every sample; emit the
    HELP/TYPE header on the first labeled family only."""
    lines = []
    if help_:
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} histogram")
    lab = (
        "".join(f'{k}="{v}",' for k, v in labels.items()) if labels else ""
    )
    cum = 0
    for bound, count in zip(hist.bounds, hist.counts):
        cum += count
        le = repr(float(bound)) if bound != int(bound) else str(int(bound))
        lines.append(f'{name}_bucket{{{lab}le="{le}"}} {cum}')
    cum += hist.counts[-1]
    lines.append(f'{name}_bucket{{{lab}le="+Inf"}} {cum}')
    if lab:
        lines.append(f"{name}_sum{{{lab[:-1]}}} {hist.sum}")
        lines.append(f"{name}_count{{{lab[:-1]}}} {hist.count}")
    else:
        lines.append(f"{name}_sum {hist.sum}")
        lines.append(f"{name}_count {hist.count}")
    return lines


def trace_metric_lines(trace: Any) -> list[str]:
    """Flight-recorder health shared by both roles (tracing.py): a
    recorder silently disabled or a ring too small for the flood rate is
    observable here."""
    return [
        prom_line(
            "dtpu_trace_events_total", trace.total,
            help_="Flight-recorder events emitted since start",
            type_="counter",
        ),
        prom_line(
            "dtpu_trace_ring_events", len(trace),
            help_="Flight-recorder events currently resident in the ring",
            type_="gauge",
        ),
    ]


def selfprofile_metric_lines(wall: Any, profiler: Any = None,
                             watchdog: Any = None) -> list[str]:
    """Control-plane self-profiling exposition shared by both roles
    (diagnostics/selfprofile.py; docs/observability.md
    "Self-profiling"): the wall budget's per-phase totals, the sampler's
    counters, and the loop watchdog's lag histogram + stall counters.
    "Where did the scheduler's second go" is answerable from /metrics
    alone — the profile trees add the stack detail at /profile."""
    lines = []
    if wall is not None:
        first = True
        for phase, secs in sorted(wall.snapshot().items()):
            lines.append(
                prom_line(
                    "dtpu_wall_seconds_total", secs, {"phase": phase},
                    help_="Exact monotonic wall seconds spent per "
                          "control-plane phase (self time)"
                    if first else None,
                    type_="counter",
                )
            )
            first = False
        first = True
        for phase, n in sorted(wall.snapshot_counts().items()):
            lines.append(
                prom_line(
                    "dtpu_wall_phase_entries_total", n, {"phase": phase},
                    help_="Times each control-plane phase was entered"
                    if first else None,
                    type_="counter",
                )
            )
            first = False
    if profiler is not None:
        lines.append(
            prom_line(
                "dtpu_profile_samples_total", profiler.total_samples,
                help_="Control-plane stack samples taken",
                type_="counter",
            )
        )
        lines.append(
            prom_line(
                "dtpu_profile_idle_samples_total", profiler.idle_samples,
                help_="Samples that caught the loop idle in select() "
                      "(counted apart from the tree)",
                type_="counter",
            )
        )
    if watchdog is not None:
        lines.extend(
            prom_histogram_lines(
                "dtpu_loop_lag_seconds", watchdog.hist_lag,
                help_="Event-loop scheduling lag per watchdog tick "
                      "(actual gap minus the nominal interval)",
            )
        )
        lines.append(
            prom_line(
                "dtpu_loop_ticks_total", watchdog.ticks_total,
                help_="Stall-watchdog ticks observed on the loop",
                type_="counter",
            )
        )
        lines.append(
            prom_line(
                "dtpu_loop_stalls_total", watchdog.stalls_total,
                help_="Loop stalls captured (lag beyond "
                      "scheduler.profile.stall-threshold)",
                type_="counter",
            )
        )
    return lines


def census_metric_lines(census: Any) -> list[str]:
    """``dtpu_census_*`` exposition (diagnostics/census.py;
    docs/observability.md "State census & retention"): per-family
    resident counts + sentinel growth slopes for the cheap (O(1))
    families, quiesce state, audit health, and leak-finding counters —
    the live answer to "what are we still holding"."""
    lines = [
        prom_line(
            "dtpu_census_families", len(census.families),
            help_="Container families registered with the state census",
            type_="gauge",
        ),
        prom_line(
            "dtpu_census_quiesced", 1 if census.quiesced() else 0,
            help_="1 when every census motion family reads zero "
                  "(no tasks, nothing in flight)",
            type_="gauge",
        ),
        prom_line(
            "dtpu_census_audits_total", census.audits,
            help_="Walk-vs-counter census audits run",
            type_="counter",
        ),
        prom_line(
            "dtpu_census_audit_failures_total", census.audit_failures,
            help_="Census audits that found counter/walk drift",
            type_="counter",
        ),
        prom_line(
            "dtpu_census_findings_total", census.findings_total,
            help_="Non-allowlisted residue findings recorded at quiesce",
            type_="counter",
        ),
    ]
    sent = census.sentinel
    lines.append(
        prom_line(
            "dtpu_census_leaks_flagged_total",
            sent.leaks_flagged if sent is not None else 0,
            help_="Census families flagged by the retention sentinel's "
                  "growth-slope EWMA",
            type_="counter",
        )
    )
    first = True
    for name, fam in census.families.items():
        if fam.cost != "o1":
            continue
        lines.append(
            prom_line(
                "dtpu_census_count", fam.probe(), {"family": name},
                help_="Resident members per census family (cheap "
                      "families only; walk families via the get_census "
                      "RPC deep=True or cluster dumps)"
                if first else None,
                type_="gauge",
            )
        )
        first = False
    first = True
    for name, fam in census.families.items():
        if fam.cost != "o1":
            continue
        lines.append(
            prom_line(
                "dtpu_census_growth_per_s", round(fam.slope, 3),
                {"family": name},
                help_="Sentinel EWMA of members/second growth per "
                      "census family" if first else None,
                type_="gauge",
            )
        )
        first = False
    return lines


#: computed once per process and device: the identity labels never change
_BUILD_INFO_CACHE: dict[tuple[str, str], str] = {}


def build_info_lines(role: str, device: Any) -> list[str]:
    """``dtpu_build_info`` — the standard always-1 identity gauge: which
    build/runtime is behind this /metrics endpoint.  The port's labels
    (``http/build_info.py``) name its version, torch, CUDA, backend and
    card and the engine-mesh layout where the reference's name jax.
    ``device`` is the role's: the scheduler's ``state.device``, a worker's
    :func:`process_device`.  Computed once per role and device."""
    from distributed_tpu_torch._device import resolve_device

    dev = resolve_device(device)
    cached = _BUILD_INFO_CACHE.get((role, str(dev)))
    if cached is None:
        from distributed_tpu_torch import config
        from distributed_tpu_torch.http import build_info

        mesh = (
            f"{config.get('scheduler.jax.mesh.enabled')}"
            f"/{config.get('scheduler.jax.mesh.layout')}"
        )
        (cached,) = build_info.build_info_lines(role, mesh=mesh, device=dev)
        _BUILD_INFO_CACHE[(role, str(dev))] = cached
    return [cached]


def process_device() -> Any:
    """The device torch runs on by default in this process: the card when
    it has one, else the CPU.  A worker's build info names it, as the
    reference's names the backend jax picks (a worker runs what its tasks
    ask for, so it has no device of its own)."""
    import torch

    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


#: exposition cap on ledger per-link label pairs (same rationale as
#: TELEMETRY_MAX_LINKS below) and per-prefix rows
LEDGER_MAX_LABELS = 64


def ledger_metric_lines(ledger: Any) -> list[str]:
    """``dtpu_ledger_*`` exposition (ledger.py; docs/observability.md
    "Decision ledger & critical-path"): join health counters, the
    per-kind regret histograms for BOTH cost models, and bounded
    per-prefix / per-link regret aggregates — the live answer to "how
    wrong were the decisions we just made"."""
    import heapq

    lines = [
        prom_line(
            "dtpu_ledger_rows_total", ledger.filed_total,
            help_="Decision rows filed (placements, steals, AMM "
                  "replica decisions)",
            type_="counter",
        ),
        prom_line(
            "dtpu_ledger_joined_total", ledger.joined_total,
            help_="Decision rows joined to a realized outcome",
            type_="counter",
        ),
        prom_line(
            "dtpu_ledger_unjoined_total", ledger.unjoined_total,
            help_="Open rows aged out of the ring before their outcome "
                  "arrived (ring too small or outcomes never reported)",
            type_="counter",
        ),
        prom_line(
            "dtpu_ledger_superseded_total", ledger.superseded_total,
            help_="Rows replaced by a newer decision for the same key "
                  "before reality tested them (steal churn)",
            type_="counter",
        ),
        prom_line(
            "dtpu_ledger_open_rows", ledger.open_rows,
            help_="Decisions currently awaiting their outcome",
            type_="gauge",
        ),
    ]
    first = True
    for (kind, model), hist in sorted(ledger.hists.items()):
        lines.extend(
            prom_histogram_lines(
                "dtpu_ledger_regret_seconds", hist,
                help_="Per-decision regret: realized non-compute "
                      "seconds minus the model's predicted comm cost "
                      "(signed; labels kind + cost model)"
                if first else None,
                labels={"kind": kind, "model": model},
            )
        )
        first = False
    top_prefixes = heapq.nlargest(
        LEDGER_MAX_LABELS, ledger.prefix_agg.items(),
        key=lambda kv: kv[1][0],
    )
    first = True
    for prefix, (n, abs_c, abs_m) in top_prefixes:
        for model, v in (("constant", abs_c), ("measured", abs_m)):
            lines.append(
                prom_line(
                    "dtpu_ledger_prefix_regret_seconds_total", v,
                    {"prefix": prefix, "model": model},
                    help_="Absolute regret accumulated per task prefix "
                          "and cost model"
                    if first else None,
                    type_="counter",
                )
            )
            first = False
    first = True
    for prefix, (n, *_rest) in top_prefixes:
        lines.append(
            prom_line(
                "dtpu_ledger_prefix_decisions_total", n,
                {"prefix": prefix},
                help_="Regret-observed decisions per task prefix"
                if first else None,
                type_="counter",
            )
        )
        first = False
    top_links = heapq.nlargest(
        LEDGER_MAX_LABELS, ledger.link_agg.items(),
        key=lambda kv: kv[1][0],
    )
    first = True
    for (src, dst), (n, transfer_s, abs_c, abs_m) in top_links:
        for model, v in (("constant", abs_c), ("measured", abs_m)):
            lines.append(
                prom_line(
                    "dtpu_ledger_link_regret_seconds_total", v,
                    {"src": src, "dst": dst, "model": model},
                    help_="Absolute regret accumulated per dominant "
                          "dep link and cost model"
                    if first else None,
                    type_="counter",
                )
            )
            first = False
    first = True
    for (src, dst), (n, transfer_s, _ac, _am) in top_links:
        lines.append(
            prom_line(
                "dtpu_ledger_link_transfer_seconds_total", transfer_s,
                {"src": src, "dst": dst},
                help_="Realized transfer seconds attributed per "
                      "dominant dep link (telemetry-priced at join)"
                if first else None,
                type_="counter",
            )
        )
        first = False
    first = True
    for (src, dst), (n, *_rest) in top_links:
        lines.append(
            prom_line(
                "dtpu_ledger_link_decisions_total", n,
                {"src": src, "dst": dst},
                help_="Regret-observed decisions per dominant dep link"
                if first else None,
                type_="counter",
            )
        )
        first = False
    return lines


#: exposition cap on per-link label pairs — links are O(workers^2) and
#: a big fleet must not turn /metrics into megabytes; the top spenders
#: by moved bytes are the ones a cost-model investigation wants
TELEMETRY_MAX_LINKS = 64


def telemetry_metric_lines(tel: Any) -> list[str]:
    """``dtpu_link_*`` exposition shared by both roles: the measured-
    truth per-link transfer stats (telemetry.py).  On the scheduler
    ``tel`` is the fleet aggregate; on a worker it is that node's own
    collector."""
    import heapq

    # nlargest, not a full sort: links are O(workers^2) and this runs
    # on the event loop at every Prometheus scrape
    links = heapq.nlargest(
        TELEMETRY_MAX_LINKS, tel.links.values(),
        key=lambda ln: ln.bytes_total,
    )
    lines = []
    for name, attr, help_, type_ in (
        ("bandwidth_bytes_per_second", "bandwidth",
         "Measured per-link transfer bandwidth (EWMA, dst-observed)",
         "gauge"),
        ("latency_seconds", "latency",
         "Measured per-link residual latency (EWMA, dst-observed)",
         "gauge"),
    ):
        first = True
        for link in links:
            lines.append(
                prom_line(
                    f"dtpu_link_{name}",
                    getattr(link, attr).value,
                    {"src": link.src, "dst": link.dst},
                    help_=help_ if first else None, type_=type_,
                )
            )
            first = False
    first = True
    for link in links:
        lines.append(
            prom_line(
                "dtpu_link_transfer_bytes_total", link.bytes_total,
                {"src": link.src, "dst": link.dst},
                help_="Payload bytes moved per link (dst-observed)"
                if first else None,
                type_="counter",
            )
        )
        first = False
    first = True
    for link in links:
        lines.append(
            prom_line(
                "dtpu_link_samples_total", link.bandwidth.count,
                {"src": link.src, "dst": link.dst},
                help_="Transfer samples folded per link (dst-observed)"
                if first else None,
                type_="counter",
            )
        )
        first = False
    first = True
    for link in links:
        if not link.peer_count:
            continue
        lines.append(
            prom_line(
                "dtpu_link_served_wire_bytes_total", link.peer_bytes,
                {"src": link.src, "dst": link.dst},
                help_="True wire bytes the serving end reported per link "
                      "(the framing-overhead cross-check)"
                if first else None,
                type_="counter",
            )
        )
        first = False
    return lines


def cluster_telemetry_metric_lines(tel: Any) -> list[str]:
    """Scheduler-only telemetry exposition: heartbeat RTTs, task-prefix
    priors, and the shadow cost-model divergence monitor
    (telemetry.py; docs/observability.md)."""
    lines = telemetry_metric_lines(tel)
    first = True
    for worker, rtt in sorted(tel.rtt.items()):
        lines.append(
            prom_line(
                "dtpu_link_heartbeat_rtt_seconds", rtt,
                {"worker": worker},
                help_="Scheduler<->worker heartbeat round trip "
                      "(worker-measured EWMA, monotonic stamps)"
                if first else None,
                type_="gauge",
            )
        )
        first = False
    for name, attr, help_ in (
        ("dtpu_prior_duration_seconds", "duration",
         "Measured per-prefix task duration (EWMA)"),
        ("dtpu_prior_nbytes", "nbytes",
         "Measured per-prefix output bytes (EWMA)"),
    ):
        first = True
        for prefix, prior in sorted(tel.priors.items()):
            lines.append(
                prom_line(
                    name, getattr(prior, attr).value, {"prefix": prefix},
                    help_=help_ if first else None, type_="gauge",
                )
            )
            first = False
    first = True
    for prefix, prior in sorted(tel.priors.items()):
        lines.append(
            prom_line(
                "dtpu_prior_tasks_total", prior.n_tasks,
                {"prefix": prefix},
                help_="Executions folded into the prefix priors"
                if first else None,
                type_="counter",
            )
        )
        first = False
    lines.extend(
        prom_histogram_lines(
            "dtpu_costmodel_divergence_ratio", tel.hist_divergence,
            help_="Shadow cost model: measured/constant comm-cost ratio "
                  "per sampled placement/steal decision",
        )
    )
    lines.append(
        prom_line(
            "dtpu_costmodel_shadow_evals_total", tel.shadow_evals,
            help_="Shadow cost-model evaluations performed",
            type_="counter",
        )
    )
    lines.append(
        prom_line(
            "dtpu_costmodel_shadow_measured_total", tel.shadow_measured,
            help_="Shadow evaluations where a measured link priced a "
                  "dependency",
            type_="counter",
        )
    )
    return lines


def wire_metric_lines() -> list[str]:
    """``dtpu_wire_*`` exposition shared by every server role: the
    zero-copy data plane counters (protocol/buffers.py).  A production
    regression — payload copies creeping back onto the send path, pool
    hit rate collapsing, compression volume vanishing — is observable
    here, not only in tests."""
    from distributed_tpu_torch.protocol.buffers import WIRE, recv_pool

    lines = []
    for name, help_ in (
        ("bytes_sent", "Bytes written to comm transports"),
        ("bytes_recv", "Bytes read from comm transports"),
        ("payload_copies", "Payload-frame materializations on the wire path"),
        ("pool_hits", "Receive-buffer pool hits"),
        ("pool_misses", "Receive-buffer pool misses (fresh allocations)"),
        ("pool_drops", "Pooled buffers dropped (live views or budget)"),
        ("compress_bytes_in", "Uncompressed bytes entering frame compression"),
        ("compress_bytes_out", "Compressed bytes leaving frame compression"),
        ("decompress_bytes_in", "Compressed bytes entering decompression"),
    ):
        lines.append(
            prom_line(
                f"dtpu_wire_{name}_total", getattr(WIRE, name),
                help_=help_, type_="counter",
            )
        )
    lines.append(
        prom_line(
            "dtpu_wire_pool_bytes", recv_pool().pooled_bytes,
            help_="Bytes currently cached in the receive-buffer pool",
            type_="gauge",
        )
    )
    return lines


def scheduler_metrics(scheduler: Any) -> bytes:
    """Prometheus exposition for the scheduler
    (reference http/scheduler/prometheus/core.py)."""
    s = scheduler.state
    lines = build_info_lines("scheduler", s.device)
    by_state: dict[str, int] = {}
    for ts in s.tasks.values():
        by_state[ts.state] = by_state.get(ts.state, 0) + 1
    lines.append("# HELP dtpu_scheduler_tasks Tasks by state")
    lines.append("# TYPE dtpu_scheduler_tasks gauge")
    for state, n in sorted(by_state.items()):
        lines.append(prom_line("dtpu_scheduler_tasks", n, {"state": state}))
    lines.append(
        prom_line(
            "dtpu_scheduler_workers", len(s.workers),
            help_="Registered workers", type_="gauge",
        )
    )
    lines.append(
        prom_line(
            "dtpu_scheduler_clients", len(s.clients),
            help_="Connected clients", type_="gauge",
        )
    )
    lines.append(
        prom_line(
            "dtpu_scheduler_total_occupancy", s.total_occupancy,
            help_="Seconds of queued work", type_="gauge",
        )
    )
    stealing = scheduler.extensions.get("stealing")
    if stealing is not None:
        lines.append(
            prom_line(
                "dtpu_stealing_moves_total", stealing.count,
                help_="Confirmed task steals", type_="counter",
            )
        )
    # scheduler durability (scheduler/durability.py; docs/durability.md):
    # snapshot/segment capture economics + the measured recovery (RTO)
    # of the last restore — absent entirely when durability is off
    dur = getattr(scheduler, "durability", None)
    if dur is not None:
        st = dur.stats
        for name, val, help_, type_ in (
            ("dtpu_durability_snapshot_seconds_total", st.snapshot_seconds,
             "Wall seconds encoding snapshots (on-loop half)", "counter"),
            ("dtpu_durability_snapshot_bytes_total", st.snapshot_bytes,
             "Snapshot bytes handed to the durable sink", "counter"),
            ("dtpu_durability_snapshot_rows_total", st.snapshot_rows,
             "Task rows serialized across snapshots (delta-encoded: "
             "O(changed) per epoch)", "counter"),
            ("dtpu_durability_epochs_total", st.epochs,
             "Snapshot epochs written", "counter"),
            ("dtpu_durability_base_epochs_total", st.base_epochs,
             "Full (base) snapshot epochs written", "counter"),
            ("dtpu_durability_journal_records_total", st.journal_records,
             "Stimulus records captured into journal segments", "counter"),
            ("dtpu_durability_journal_bytes_total", st.journal_bytes,
             "Journal segment bytes handed to the durable sink",
             "counter"),
            ("dtpu_durability_replay_records", st.replay_records,
             "Journal-tail records replayed by the last restore",
             "gauge"),
            ("dtpu_durability_restore_seconds", st.restore_seconds,
             "Measured RTO of the last restore (load + rebuild + "
             "digest check + tail replay)", "gauge"),
            ("dtpu_durability_torn_records_total", st.torn_records,
             "Torn final journal records dropped at restore", "counter"),
            ("dtpu_durability_reconcile_corrections_total",
             st.reconcile_corrections,
             "who_has corrections applied by worker re-registration "
             "reconciliation", "counter"),
        ):
            lines.append(prom_line(name, val, help_=help_, type_=type_))
        rec = getattr(scheduler, "_recovery", None)
        lines.append(
            prom_line(
                "dtpu_durability_recovery_awaiting_workers",
                len(rec["awaiting"]) if rec else 0,
                help_="Restored workers still inside the re-registration "
                      "grace window", type_="gauge",
            )
        )
    mirror = getattr(s, "mirror", None)
    if mirror is not None:
        # fleet-mirror health (scheduler/mirror.py): a production
        # regression — a consumer silently falling back to from-scratch
        # packs, upload volume creeping back toward O(W), oracle-check
        # failures — is observable here, not only on the bench
        gauges = ("generation", "capacity", "dirty_high_water")
        counters = (
            "deltas_applied", "rows_refreshed", "rows_uploaded",
            "bytes_uploaded", "full_uploads", "membership_rebuilds",
            "oracle_checks", "oracle_failures", "oracle_packs",
        )
        stats = mirror.stats()
        for name in gauges:
            lines.append(
                prom_line(
                    f"dtpu_mirror_{name}", stats[name],
                    help_=f"Fleet mirror {name.replace('_', ' ')}",
                    type_="gauge",
                )
            )
        for name in counters:
            lines.append(
                prom_line(
                    f"dtpu_mirror_{name}_total", stats[name],
                    help_=f"Fleet mirror {name.replace('_', ' ')}",
                    type_="counter",
                )
            )
        # per-shard mirror upload counters (sharded_device_view, the
        # mesh plan path): a fresh cycle must read 0 rows on EVERY
        # shard; full packs only move on growth/mesh changes
        ss = mirror.sharded_stats()
        if ss["n_shards"]:
            for name, help_ in (
                ("rows_uploaded", "Mirror rows scattered to this shard"),
                ("bytes_uploaded", "Mirror bytes scattered to this shard"),
                ("full_packs", "Full fleet packs shipped to this shard"),
            ):
                lines.append(f"# HELP dtpu_mirror_shard_{name}_total {help_}")
                lines.append(f"# TYPE dtpu_mirror_shard_{name}_total counter")
                for shard_i, v in enumerate(ss[name]):
                    lines.append(
                        prom_line(
                            f"dtpu_mirror_shard_{name}_total", v,
                            {"shard": str(shard_i)},
                        )
                    )
    # per-shard sharded-placement-engine telemetry (mesh plan path,
    # scheduler/jax_placement.py -> SchedulerState.observe_engine_shards)
    if getattr(s, "engine_shards", None):
        lines.append(
            "# HELP dtpu_engine_shard_kernel_ms Sharded placement kernel "
            "completion ms per mesh shard (last plan)"
        )
        lines.append("# TYPE dtpu_engine_shard_kernel_ms gauge")
        for shard_i, row in enumerate(s.engine_shards):
            lines.append(
                prom_line(
                    "dtpu_engine_shard_kernel_ms", row["kernel_ms"],
                    {"shard": str(shard_i)},
                )
            )
        lines.append(
            "# HELP dtpu_engine_shard_h2d_bytes_total Task-tile bytes "
            "shipped to this mesh shard by the sharded engine"
        )
        lines.append("# TYPE dtpu_engine_shard_h2d_bytes_total counter")
        for shard_i, row in enumerate(s.engine_shards):
            lines.append(
                prom_line(
                    "dtpu_engine_shard_h2d_bytes_total", row["h2d_bytes"],
                    {"shard": str(shard_i)},
                )
            )
    # native transition engine (scheduler/native_engine.py): compiled
    # vs escaped transition totals — an escape-rate regression (a new
    # arm or flag the C++ core does not model) is visible here long
    # before it is a perf cliff
    ne = getattr(s, "native", None)
    if ne is not None:
        c = ne.counters()
        lines.append(
            "# HELP dtpu_engine_native_transitions_total Transitions "
            "executed by the compiled (C++) engine"
        )
        lines.append("# TYPE dtpu_engine_native_transitions_total counter")
        lines.append(
            prom_line("dtpu_engine_native_transitions_total",
                      c["transitions"])
        )
        lines.append(
            "# HELP dtpu_engine_native_escapes_total Per-key escapes "
            "from the compiled engine to the python oracle, by reason"
        )
        lines.append("# TYPE dtpu_engine_native_escapes_total counter")
        lines.append(
            prom_line("dtpu_engine_native_escapes_total", c["escapes"],
                      {"why": "all"})
        )
        for k, v in c.items():
            if k.startswith("escape_"):
                lines.append(
                    prom_line("dtpu_engine_native_escapes_total", v,
                              {"why": k[len("escape_"):]})
                )
        lines.append(
            "# HELP dtpu_engine_native_oracle_transitions_total "
            "Transitions run by the python oracle while the native "
            "engine was attached (escape chains + fallback floods)"
        )
        lines.append(
            "# TYPE dtpu_engine_native_oracle_transitions_total counter"
        )
        lines.append(
            prom_line("dtpu_engine_native_oracle_transitions_total",
                      c["oracle_transitions"])
        )
        # deferred materialization (authoritative SoA): how much python
        # truth deferred replay has had to build, and how often a read
        # barrier found everything already hydrated.  A hydration count
        # tracking the transition count means something reads python
        # objects every flood — the lazy contract is not paying off.
        lines.append(
            "# HELP dtpu_engine_hydrations_total Tape rows replayed "
            "into python objects by deferred materialization"
        )
        lines.append("# TYPE dtpu_engine_hydrations_total counter")
        lines.append(
            prom_line("dtpu_engine_hydrations_total", c["hydrations"])
        )
        lines.append(
            "# HELP dtpu_engine_hydration_cache_hits_total Sync-barrier "
            "probes that found no deferred segments pending"
        )
        lines.append(
            "# TYPE dtpu_engine_hydration_cache_hits_total counter"
        )
        lines.append(
            prom_line("dtpu_engine_hydration_cache_hits_total",
                      c["hydration_cache_hits"])
        )
        lines.append(
            "# HELP dtpu_engine_hydration_cache_rows Live task rows "
            "whose python mirror is fully materialized (hydrated)"
        )
        lines.append("# TYPE dtpu_engine_hydration_cache_rows gauge")
        lines.append(
            prom_line("dtpu_engine_hydration_cache_rows",
                      c["hydration_cache_rows"])
        )
    # batched-engine + egress-coalescer histograms (tracing.Histogram,
    # observed in scheduler/state.py and Scheduler.stream_payload_flush)
    for name, hist, help_ in (
        ("dtpu_engine_transition_batch_size", s.hist_engine_batch,
         "Recommendations/events folded per engine pass"),
        ("dtpu_engine_pass_seconds", s.hist_engine_pass,
         "Wall seconds per batched transition-engine pass"),
        ("dtpu_egress_envelope_msgs", s.hist_egress,
         "Messages folded per coalesced worker-stream envelope"),
    ):
        lines.extend(prom_histogram_lines(name, hist, help_=help_))
    lines.extend(cluster_telemetry_metric_lines(s.telemetry))
    lines.extend(ledger_metric_lines(s.ledger))
    lines.extend(census_metric_lines(s.census))
    lines.extend(trace_metric_lines(s.trace))
    lines.extend(
        selfprofile_metric_lines(
            s.wall,
            getattr(scheduler, "cp_profiler", None),
            getattr(scheduler, "watchdog", None),
        )
    )
    lines.extend(wire_metric_lines())
    return ("\n".join(lines) + "\n").encode()


def worker_metrics(worker: Any) -> bytes:
    """Prometheus exposition for a worker (reference http/worker/prometheus/)."""
    st = worker.state
    lines = build_info_lines("worker", process_device())
    lines += [
        prom_line("dtpu_worker_tasks_executing", len(st.executing),
                  help_="Currently executing", type_="gauge"),
        prom_line("dtpu_worker_tasks_ready", len(st.ready)),
        prom_line("dtpu_worker_tasks_stored", len(worker.data)),
        prom_line("dtpu_worker_nbytes", st.nbytes_in_memory,
                  help_="Managed memory bytes", type_="gauge"),
        prom_line("dtpu_worker_transfers_incoming", st.transfer_incoming_count),
        prom_line("dtpu_worker_get_data_wire_bytes_total",
                  worker.get_data_wire_bytes,
                  help_="Wire bytes served to peers via get_data",
                  type_="counter"),
    ]
    data = worker.data
    if hasattr(data, "spilled_count"):
        lines.append(
            prom_line("dtpu_worker_spill_count_total", data.spilled_count,
                      type_="counter")
        )
        lines.append(prom_line("dtpu_worker_spill_bytes", data.slow_bytes))
    lines.extend(telemetry_metric_lines(worker.telemetry))
    lines.extend(census_metric_lines(st.census))
    lines.extend(trace_metric_lines(st.trace))
    lines.extend(
        selfprofile_metric_lines(
            st.wall,
            getattr(worker, "cp_profiler", None),
            getattr(worker, "watchdog", None),
        )
    )
    lines.extend(wire_metric_lines())
    return ("\n".join(lines) + "\n").encode()
