"""Whether the device trace keeps every kernel, long after a process's
first trace, with and without its settle.

Run from a checkout on a machine with one NVIDIA GPU:

    python3 distributed_tpu_torch/profile_trace.py [--plan AGE:SETTLE,...] [--out FILE]

In one process it takes a trace of a task at each planned age (seconds
since the process started; the first trace is the process's first) with
``device_profile.SETTLE_S`` set to the planned settle (seconds, 0 for
none): on a pool thread made before the trace, K2 at seq 8192 / 16 heads
/ dim 128 bf16 causal under the task's span and once after it, then ten
small kernels on the calling thread.  Each trace prints one JSON line:
its age, the settle, ``start()``'s host ms, the kernel launches whose
kernel the trace lacks beside all of its launches, K2's kernels kept, and
``stop()``'s status.  Between traces the card is idle.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import sys
import threading
import time
from pathlib import Path

PLAN = "3:0,60:0,70:0.02,130:0.02,140:0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plan", default=PLAN, help="age:settle pairs, seconds")
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
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        pool.submit(threading.get_native_id).result()
        for pair in args.plan.split(","):
            age, settle = (float(s) for s in pair.split(":"))
            while time.monotonic() - t0 < age:
                time.sleep(0.05)
            device_profile.SETTLE_S = settle
            t = time.perf_counter()
            rep = device_profile.start()
            start_ms = (time.perf_counter() - t) * 1e3
            if rep["status"] != "OK":
                raise RuntimeError(f"device_profile.start: {rep}")

            def task():
                with device_profile.annotate("task-k2"):
                    flash.flash_forward_cuda(q, k, v, True, scale)
                flash.flash_forward_cuda(q, k, v, True, scale)
                torch.cuda.synchronize()

            pool.submit(task).result()
            for _ in range(10):
                x.add_(1)
            torch.cuda.synchronize()
            rep = device_profile.stop()
            with open(os.path.join(rep["logdir"], device_profile.TRACE_FILE)) as f:
                trace = json.load(f)
            lost, launched = device_profile.lost_launches(trace)
            k2 = sum(e.get("cat") == "kernel" and "flash_fwd" in e.get("name", "")
                     for e in trace["traceEvents"])
            line = json.dumps(dict(age_s=round(time.monotonic() - t0, 1), settle_s=settle,
                                   start_ms=start_ms, lost=lost, launches=launched, k2_kernels=k2,
                                   status=rep["status"]))
            print(line, flush=True)
            lines.append(line)
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
