"""Where the placement upload's time goes, on the card.

Run from the repository root on a machine with a CUDA device:

    python3 distributed_tpu_torch/profile_upload.py [--tasks N] [--root DIR]

``--root`` names the checkout whose ``distributed_tpu_torch`` is
measured (default: the one holding this file); for a version without
the chunked wire only the ``LeveledRun`` line is measured, so one
command can compare two versions in turns.  For the 1M-task random DAG
of ``chip_smoke.py``, it times, each the median of several runs:

- the host encode of the whole wire, f16 and packed, into ordinary and
  into pinned memory (host clock);
- one host-to-device copy of the f16 wire's 16 B/task from pageable and
  from pinned memory, and the same bytes as the streamed driver sends
  them (six copies a chunk of 131072 rows), by CUDA events;
- ``LeveledRun`` construction (allocate, encode, pinned side-stream
  upload), CUDA events around it, as ``chip_smoke.py`` phase 3 times it.

It prints one line per measurement and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch


def host_ms(fn, reps=5):
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def cuda_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tasks", type=int, default=1_000_000)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    from distributed_tpu_torch import graphs
    from distributed_tpu_torch.ops import leveled
    if not torch.cuda.is_available():
        print("profile_upload: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card {card} root {args.root}")
    packed = leveled.pack_graph(*graphs.random_dag(args.tasks, seed=0))
    T = packed.n
    fleet = (np.full(512, 2, np.int32), np.zeros(512, np.float32), np.ones(512, bool))
    dev = torch.device("cuda")

    if not hasattr(leveled, "WIRE_BYTES"):
        ms = cuda_ms(lambda: leveled.LeveledRun(packed, *fleet, device=dev))
        print(f"LeveledRun(f16) construction: {ms:.2f} ms ({card})")
        return 0
    for fmt in ("f16", "packed"):
        nbytes = leveled.WIRE_BYTES[fmt] * T
        spans = leveled._wire_spans(T, fmt)
        for where, buf in (("ordinary", torch.empty(nbytes, dtype=torch.uint8)),
                           ("pinned", torch.empty(nbytes, dtype=torch.uint8, pin_memory=True))):
            host = buf.numpy()
            views = {name: host[lo: lo + size * T].view(leveled._NP_DTYPE[d])
                     for name, d, lo, size in spans}
            ms = host_ms(lambda: leveled._encode_rows(packed, fmt, 0, T, views))
            print(f"encode {fmt} into {where} memory: {ms:.2f} ms ({card})")

    nbytes = 16 * T
    dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    pageable = torch.empty(nbytes, dtype=torch.uint8)
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    for label, src in (("pageable", pageable), ("pinned", pinned)):
        ms = cuda_ms(lambda: dst.copy_(src, non_blocking=True))
        print(f"one copy of {nbytes / 1e6:.1f} MB from {label} memory: {ms:.3f} ms, "
              f"{nbytes / ms / 1e6:.2f} GB/s ({card})")
    chunk = 131072
    ranges = [(lo + size * i0, lo + size * min(i0 + chunk, T))
              for i0 in range(0, T, chunk)
              for _, _, lo, size in leveled._wire_spans(T, "f16")]

    def chunked():
        for a, b in ranges:
            dst[a:b].copy_(pinned[a:b], non_blocking=True)

    ms = cuda_ms(chunked)
    print(f"the same bytes in {len(ranges)} pinned copies (chunks of {chunk} rows): "
          f"{ms:.3f} ms, {nbytes / ms / 1e6:.2f} GB/s ({card})")
    for fmt in ("f16", "packed"):
        ms = cuda_ms(lambda: leveled.LeveledRun(packed, *fleet, device=dev, fmt=fmt))
        print(f"LeveledRun({fmt}) construction: {ms:.2f} ms ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
