"""Whether the device trace keeps every kernel, long after a process's
first trace, with and without its settle.

Run from a checkout on a machine with one NVIDIA GPU:

    python3 distributed_tpu_torch/profile_trace.py [--plan AGE:SETTLE,...] [--pairs N]
        [--out FILE]

In one process it takes a trace of a task at each planned age (seconds
since the process started; the first trace is the process's first) with
``device_profile.SETTLE_S`` set to the planned settle (seconds, 0 for
none): on a pool thread made before the trace, K2 at seq 8192 / 16 heads
/ dim 128 bf16 causal under the task's span and once after it, then ten
small kernels on the calling thread.  Between traces the card is idle.
Then ``--pairs`` times, back to back, ``chip_smoke.py`` phase 11's two
traces: that task trace, then a timing trace of K2 (one warm-up and five
launches, each waited on).  Each trace prints one JSON line: its age,
the settle, ``device_profile.EDGE_S``, ``start()``'s host ms, the kernel
launches whose kernel the trace lacks (and their places among its
launches, in time order) beside all of its launches, K2's
kernels kept, the least and largest time from a launch to its kernel on
the trace's clock (us; the card runs a kernel after its launch, so a gap
below 0 is the error of the trace's mapping of the card's clock), and
``stop()``'s status; then a summary line.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import shutil
import sys
import threading
import time
from pathlib import Path

PLAN = "3:0,60:0,70:0.02,130:0.02,140:0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plan", default=PLAN, help="age:settle pairs, seconds")
    ap.add_argument("--pairs", type=int, default=0, help="phase 11's two traces, this often")
    ap.add_argument("--out", help="also write the lines to this file")
    args = ap.parse_args(argv)
    sys.path[0] = str(Path(__file__).resolve().parents[1])  # the checkout, not this directory
    import torch

    from distributed_tpu_torch.diagnostics import device_profile
    from distributed_tpu_torch.ops import _build, flash

    if not torch.cuda.is_available():
        print("profile_trace: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.monotonic()
    _build.load()
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(16, 8192, 128, generator=g).to("cuda", torch.bfloat16) for _ in range(3))
    x = torch.zeros(1024, device="cuda")
    scale = 128 ** -0.5
    flash.flash_forward_cuda(q, k, v, True, scale)
    torch.cuda.synchronize()
    lines = []

    def traced(kind, settle, work):
        device_profile.SETTLE_S = settle
        t = time.perf_counter()
        rep = device_profile.start()
        start_ms = (time.perf_counter() - t) * 1e3
        if rep["status"] != "OK":
            raise RuntimeError(f"device_profile.start: {rep}")
        try:
            work()
        finally:
            rep = device_profile.stop()
        with open(os.path.join(rep["logdir"], device_profile.TRACE_FILE)) as f:
            trace = json.load(f)
        shutil.rmtree(rep["logdir"])
        # places of the launches that lack their kernel (first or last
        # shows which edge of the window the mapping's error crossed), and
        # each kept kernel's start less its launch's: the card runs a
        # kernel after its launch, so a gap below 0 is the mapping's error
        pairs = device_profile.launch_pairs(trace)
        lost_at = [i for i, (_, kernel) in enumerate(pairs) if kernel is None]
        lost, launched = len(lost_at), len(pairs)
        gaps = [kernel - launch for launch, kernel in pairs if kernel is not None]
        k2 = sum(e.get("cat") == "kernel" and "flash_fwd" in e.get("name", "")
                 for e in trace["traceEvents"])
        line = json.dumps(dict(kind=kind, age_s=round(time.monotonic() - t0, 1), settle_s=settle,
                               edge_s=device_profile.EDGE_S, start_ms=round(start_ms, 1),
                               lost=lost, lost_at=lost_at, launches=launched, k2_kernels=k2,
                               gap_us=[min(gaps), max(gaps)] if gaps else None,
                               status=rep["status"]))
        print(line, flush=True)
        lines.append(line)

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        pool.submit(threading.get_native_id).result()

        def task_trace():
            def task():
                with device_profile.annotate("task-k2"):
                    flash.flash_forward_cuda(q, k, v, True, scale)
                flash.flash_forward_cuda(q, k, v, True, scale)
                torch.cuda.synchronize()

            pool.submit(task).result()
            for _ in range(10):
                x.add_(1)
            torch.cuda.synchronize()

        def timing_trace():
            for _ in range(6):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                flash.flash_forward_cuda(q, k, v, True, scale)
                end.record()
                end.synchronize()

        for pair in args.plan.split(","):
            age, settle = (float(s) for s in pair.split(":"))
            while time.monotonic() - t0 < age:
                time.sleep(0.05)
            traced("task", settle, task_trace)
        for _ in range(args.pairs):
            traced("task", device_profile.SETTLE_S, task_trace)
            traced("timing", device_profile.SETTLE_S, timing_trace)
    rows = [json.loads(ln) for ln in lines]
    gaps = [r["gap_us"][0] for r in rows if r["gap_us"]]
    print(json.dumps(dict(traces=len(rows), traces_with_lost_kernels=sum(r["lost"] > 0 for r in rows),
                          least_gap_us=min(gaps) if gaps else None,
                          traces_with_a_negative_gap=sum(g < 0 for g in gaps))), flush=True)
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
