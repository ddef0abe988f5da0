"""Worker memory introspection (the reference's memray integration role,
diagnostics/memray.py:26 — memray itself is not in this image, so the
stdlib ``tracemalloc`` fills the role with zero dependencies).

Flow mirrors the reference's start → workload → report cycle:

    async with Client(...) as c:
        await c.memory_trace_start()            # all workers
        ... run the suspect workload ...
        reports = await c.memory_trace_report(top_n=10)
        await c.memory_trace_stop()

Each worker's report carries its top allocation sites (file:line,
cumulative bytes, block counts), total traced memory, peak, and the
data-store view (managed bytes, spill counts) so leaked interpreter
memory can be told apart from legitimately stored results.
"""

from __future__ import annotations

import tracemalloc
from typing import Any

#: owners (server ids) that asked for tracing and have not stopped it.
#: tracemalloc itself is PROCESS-global — with in-process workers
#: (LocalCluster) a bare stop on one worker used to kill the trace for
#: every server in the process.  start/stop are refcounted per OWNER:
#: the underlying trace only stops when the LAST owner stops.  A bare
#: (ownerless) start/stop pair uses the "" owner, preserving the old
#: single-caller semantics.
_owners: set[str] = set()
#: True only when THIS module called tracemalloc.start(): a trace the
#: user armed themselves (PYTHONTRACEMALLOC, their own start()) is
#: never ours to stop, no matter what the owner set does
_started_here = False


def start_trace(nframes: int = 5, owner: str = "") -> dict:
    """Begin tracing allocations in this process (idempotent per
    owner)."""
    global _started_here
    _owners.add(owner)
    if not tracemalloc.is_tracing():
        tracemalloc.start(nframes)
        _started_here = True
    return {"status": "OK", "tracing": True, "owners": len(_owners)}


def stop_trace(owner: str = "") -> dict:
    """Release this owner's hold on the trace; the process-global
    tracemalloc stops only when no owner remains AND this module
    started it (an externally-armed trace is left alone)."""
    global _started_here
    _owners.discard(owner)
    if not _owners and _started_here and tracemalloc.is_tracing():
        tracemalloc.stop()
        _started_here = False
    return {
        "status": "OK",
        "tracing": tracemalloc.is_tracing(),
        "owners": len(_owners),
    }


def report(top_n: int = 10, group_by: str = "lineno") -> dict:
    """Snapshot of the top allocation sites since ``start_trace``."""
    if not tracemalloc.is_tracing():
        return {"status": "not-tracing"}
    snap = tracemalloc.take_snapshot()
    current, peak = tracemalloc.get_traced_memory()
    stats = snap.statistics(group_by)[: int(top_n)]
    return {
        "status": "OK",
        "traced_bytes": current,
        "peak_bytes": peak,
        "top": [
            {
                "site": str(st.traceback[0]) if st.traceback else "?",
                "bytes": st.size,
                "blocks": st.count,
            }
            for st in stats
        ],
    }


def worker_report(worker: Any, top_n: int = 10) -> dict:
    """report() plus the worker's data-store view: interpreter-level
    allocations vs legitimately managed task results.

    NOTE: tracemalloc is PROCESS-global.  In-process clusters
    (LocalCluster) share one trace across every worker, the scheduler
    and the client — the allocation sites are process-wide, only the
    data_store section is truly per-worker.  Per-worker attribution of
    allocation sites requires process-backed workers (Nanny /
    SubprocessCluster)."""
    out = report(top_n=top_n)
    out["process_wide"] = True
    out["data_store"] = worker.data_store_summary()
    return out
