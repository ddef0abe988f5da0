"""Where the time of the partitioner's plan goes, on the card.

Run from a checkout on a machine with one NVIDIA GPU:

    python3 distributed_tpu_torch/profile_partition.py [--out FILE]

For the graphs ``chip_smoke.py`` phase 5 sends to the partitioner (the
rechunk + tensordot proxy at G = 24 and a 16,384-task random DAG) on
1,024 lanes, it reports the pieces of ``TorchPlacement._plan_from_arrays``
(host clock, median of 5 after a warm-up, each ending in a synchronize):

- ``run_ms``: ``PartitionRun`` (block init, the two scalars, the uploads);
- ``csr_ms``: the edges grouped by task on the host, and their upload;
- ``rounds_ms``: ``partition_cuda`` (kernel K4, 16 launches);
- ``result_ms``: the labels back to the host;
- ``hints_ms``: ``hints_from_partition``, the hint dict;
- ``plan_ms``: the whole ``_plan_from_arrays``;

and, from ``torch.profiler`` over one ``partition_cuda`` call, the device
time and count of each of K4's two kernels (the per-lane load and the
rows).  Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

N_WORKERS, THREADS = 512, 2
BANDWIDTH, LATENCY = 100e6, 0.001


def _median_ms(torch, fn, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _kernel_ms(torch, fn, names):
    """{name: [device ms, count]} of the kernels whose names hold each of
    ``names``, over one call of fn (``profile_waves.kernel_times``)."""
    from distributed_tpu_torch.profile_waves import kernel_times

    times = kernel_times(torch, fn)
    if not times:
        return {n: ["not measured", 0] for n in names}
    return {n: [sum(ms for k, (ms, _) in times.items() if n in k),
                sum(c for k, (_, c) in times.items() if n in k)] for n in names}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    sys.path[0] = str(Path(__file__).resolve().parents[1])

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_partition: no CUDA device", file=sys.stderr)
        return 2
    from distributed_tpu_torch import graphs
    from distributed_tpu_torch.ops import partition as part
    from distributed_tpu_torch.scheduler import plan
    from distributed_tpu_torch.scheduler.torch_placement import TorchPlacement

    _, *blockwise = graphs.blockwise_tensordot(24)
    cases = {"blockwise24": tuple(blockwise), "random16384": graphs.random_dag(16_384, seed=0)}
    nthreads = np.full(N_WORKERS, THREADS, np.int32)
    occupancy = np.zeros(N_WORKERS, np.float32)
    running = np.ones(N_WORKERS, bool)
    addrs = [f"tcp://10.1.{w // 256}.{w % 256}:8788" for w in range(N_WORKERS)]
    lanes = [w for w in range(N_WORKERS) for _ in range(THREADS)]
    placement = TorchPlacement(sync=True)
    report = {"device": torch.cuda.get_device_name(0), "lanes": len(lanes), "cases": {}}
    for name, (durations, out_bytes, src, dst) in cases.items():
        keys = [f"{name}-{i}" for i in range(len(durations))]
        weights = (out_bytes[src] / BANDWIDTH + LATENCY).astype(np.float32)
        run = part.PartitionRun(durations, weights, src, dst, len(lanes))
        part.partition_cuda(run)
        labels = run.result()

        def fresh_csr():
            run._csr = None
            run.csr()

        row = {
            "run_ms": _median_ms(torch, lambda: part.PartitionRun(
                durations, weights, src, dst, len(lanes))),
            "csr_ms": _median_ms(torch, fresh_csr),
            "rounds_ms": _median_ms(torch, lambda: part.partition_cuda(run)),
            "result_ms": _median_ms(torch, run.result),
            "hints_ms": _median_ms(torch, lambda: plan.hints_from_partition(
                keys, labels, lanes, addrs)),
            "plan_ms": _median_ms(torch, lambda: placement._plan_from_arrays(
                keys, durations, out_bytes, src, dst, nthreads, occupancy, running,
                addrs, BANDWIDTH, LATENCY)),
            "kernels": _kernel_ms(torch, lambda: part.partition_cuda(run),
                                  ("partition_load", "partition_rows")),
        }
        report["cases"][name] = row
        print(name, json.dumps(row), flush=True)
    text = json.dumps(report)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
