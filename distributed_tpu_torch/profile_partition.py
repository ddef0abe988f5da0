"""Where the time of the partitioner's plan goes, on the card.

Run from a checkout on a machine with one NVIDIA GPU:

    python3 distributed_tpu_torch/profile_partition.py [--root DIR] [--out FILE]

``--root`` names the checkout whose ``distributed_tpu_torch`` is
measured (default: the one holding this file), so one command can time
an unpacked ``git archive`` of another commit's K4 beside this one's, in
turns on one card.  For the six plans ``chip_smoke.py`` phase 5 sends to
the partitioner (the rechunk + tensordot proxy at G = 24 and a
16,384-task random DAG on 1,024 and 1,008 lanes; the 1M-task random DAG
and the proxy at G = 96 on 16 lanes, 4 workers of 4 threads), it reports
the pieces of ``TorchPlacement._plan_from_arrays`` (host clock, median of
5 after a warm-up, 3 for the 16-lane plans, each ending in a
synchronize):

- ``run_ms``: ``PartitionRun`` (block init, the two scalars, the uploads);
- ``csr_ms``: the edges grouped by task on the host, and their upload;
- ``rounds_ms``: ``partition_cuda`` (kernel K4);
- ``result_ms``: the labels back to the host;
- ``hints_ms``: ``hints_from_partition``, the hint dict;
- ``plan_ms``: the whole ``_plan_from_arrays``;

``k4_ms``, one ``partition_cuda`` call by CUDA events (median of 10, as
phase 5 times it), its launches, from ``torch.profiler`` over one call
the device time and count of every kernel it ran, and, where the
kernel keeps a timeline (``partition_cuda(run, stamps=...)``), the
device time of its load and rows phases summed over the rounds (median
of 5; each phase ends at its grid barrier).  Beside them, from this
file's checkout (whatever ``--root`` is), phase 5's ``bound_ms`` and
``chain_ms``, and the K4 labels' digest, so two turns can be seen to
agree.  Prints one JSON object, with the card's ``nvidia-smi`` name and
power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import inspect
import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


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


def _smoke():
    """This checkout's ``chip_smoke.py``, for its fleets, bound and chain."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _phases(torch, part, run):
    """Device ms of K4's load and rows phases, each summed over the rounds
    (median of 5), from the kernel's timeline; None where the kernel under
    ``--root`` keeps none."""
    if "stamps" not in inspect.signature(part.partition_cuda).parameters:
        return None
    stamps = torch.zeros(2 * run.iters + 1, dtype=torch.int64, device=run.device)
    runs = []
    for _ in range(6):
        part.partition_cuda(run, stamps=stamps)
        t = stamps.cpu().tolist()
        runs.append([(b - a) / 1e6 for a, b in zip(t, t[1:])])
    runs = runs[1:]
    return {"load_ms": statistics.median(sum(r[0::2]) for r in runs),
            "rows_ms": statistics.median(sum(r[1::2]) for r in runs)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    sys.path[0] = str(Path(args.root).resolve())

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_partition: no CUDA device", file=sys.stderr)
        return 2
    smoke = _smoke()
    from distributed_tpu_torch import graphs
    from distributed_tpu_torch.ops import partition as part
    from distributed_tpu_torch.profile_upload import cuda_ms
    from distributed_tpu_torch.profile_waves import kernel_times
    from distributed_tpu_torch.scheduler import plan
    from distributed_tpu_torch.scheduler.torch_placement import TorchPlacement

    fleets, addrs = smoke.partition_fleets()
    graph = {g: smoke.partition_graph(graphs, g) for g, _ in smoke.PART_PLANS}
    placement = TorchPlacement(sync=True)
    sm_mhz = smoke.sm_clock_mhz()
    report = {"root": args.root, "device": torch.cuda.get_device_name(0),
              "card": smoke.smi_line(), "sm_mhz": sm_mhz, "cases": {}}
    for g, f in smoke.PART_PLANS:
        durations, out_bytes, src, dst = graph[g]
        nthreads, occupancy, running = fleets[f]
        keys = [f"{g}-{i}" for i in range(len(durations))]
        lanes = [int(w) for w in np.flatnonzero(running)
                 for _ in range(max(int(nthreads[w]), 1))]
        weights = (out_bytes[src] / smoke.BANDWIDTH + smoke.LATENCY).astype(np.float32)
        run = part.PartitionRun(durations, weights, src, dst, len(lanes))
        before = part.partition_cuda.launches
        part.partition_cuda(run)
        launches = part.partition_cuda.launches - before
        labels = run.result()
        reps = 3 if len(lanes) < 64 else 5
        times = kernel_times(torch, lambda: part.partition_cuda(run))
        bound_ms, bound_by = smoke._k4_bound_ms(run)
        row = {
            "T": len(durations), "E": len(src), "lanes": len(lanes),
            "k4_ms": cuda_ms(lambda: part.partition_cuda(run), reps=10),
            "launches": launches,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "chain_ms": smoke._chain_ms(part, run, sm_mhz),
            "labels_sha": hashlib.sha256(labels.tobytes()).hexdigest()[:16],
            "kernels": {k: list(v) for k, v in times.items()},
            "phases": _phases(torch, part, run),
        }
        row.update(host_ms(torch, part, plan, placement, run, keys, lanes, labels,
                           graph[g], fleets[f], addrs[f], smoke, reps))
        report["cases"][f"{g}_{f}"] = row
        print(f"{g}_{f}", json.dumps(row), flush=True)
        del run
        torch.cuda.empty_cache()
    text = json.dumps(report)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


def host_ms(torch, part, plan, placement, run, keys, lanes, labels, graph, fleet, addrs,
            smoke, reps):
    """The plan's pieces on the host clock."""
    durations, out_bytes, src, dst = graph
    nthreads, occupancy, running = fleet
    weights = run.host[1]

    def fresh_csr():
        run._csr = None
        run.csr()

    return {
        "run_ms": _median_ms(torch, lambda: part.PartitionRun(
            durations, weights, src, dst, len(lanes)), reps),
        "csr_ms": _median_ms(torch, fresh_csr, reps),
        "rounds_ms": _median_ms(torch, lambda: part.partition_cuda(run), reps),
        "result_ms": _median_ms(torch, run.result, reps),
        "hints_ms": _median_ms(torch, lambda: plan.hints_from_partition(
            keys, labels, lanes, addrs), reps),
        "plan_ms": _median_ms(torch, lambda: placement._plan_from_arrays(
            keys, durations, out_bytes, src, dst, nthreads, occupancy, running,
            addrs, smoke.BANDWIDTH, smoke.LATENCY), reps),
    }


if __name__ == "__main__":
    sys.exit(main())
