"""Where the time of the placement waves goes, on the card.

Run from a checkout on a machine with one NVIDIA GPU:

    python3 distributed_tpu_torch/profile_waves.py [--root DIR] [--out FILE]

``--root`` names the checkout whose ``distributed_tpu_torch`` is
measured (default: the one holding this file), so one command can
measure two versions of the package in turns.  For the 1M-task random
DAG onto 512 workers (the ``chip_smoke.py`` fleets, uniform and not), it
reports for the per-wave path ``run_waves(place_wave_cuda)`` and for the
default ``run_waves()``:

- ``wall_ms``: host clock around the waves, ending in a synchronize
  (median of 5 after a warm-up);
- ``device_ms`` and ``kernels``: the summed device time and the count of
  the kernels ``torch.profiler`` saw in one such run.

Where the package has the one-launch kernel (``place_waves_cuda``) it
also reads the kernel's own timeline (``stamps``: the device clock at
each wave's start and after each of its 8 grid barriers), summed over
the waves per phase, and runs a chain of 2000 one-task waves, whose time
a wave is the kernel's per-wave floor (its barriers, its ranking of the
workers).  Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

N_TASKS = 1_000_000
N_WORKERS = 512


def _fleets(np):
    uniform = (np.full(N_WORKERS, 2, np.int32), np.zeros(N_WORKERS, np.float32),
               np.ones(N_WORKERS, bool))
    running = np.ones(N_WORKERS, bool)
    running[:8] = False
    mixed = (np.full(N_WORKERS, 2, np.int32),
             np.random.default_rng(1).uniform(0, 5, N_WORKERS).astype(np.float32), running)
    return {"uniform": uniform, "nonuniform": mixed}


def kernel_times(torch, fn, tries=3):
    """{kernel name: (device ms, count)} of one call of fn, from
    torch.profiler; a trace that caught no kernel (it happens) is taken
    again.  ``profile_partition.py`` reads its kernels here too."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = {}
        for evt in prof.key_averages():
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = getattr(evt, "self_cuda_time_total", 0.0)
            if us and str(getattr(evt, "device_type", "")).endswith("CUDA"):
                ms, n = out.get(evt.key, (0.0, 0))
                out[evt.key] = (ms + us / 1e3, n + evt.count)
        if out:
            break
    return out


def _profile(torch, fn):
    """(device ms, kernel count) of one call of fn."""
    times = kernel_times(torch, fn).values()
    return sum(ms for ms, _ in times), sum(n for _, n in times)


PHASES = ("rank_tentative_count", "offsets", "scatter", "sums", "contend_count",
          "offsets_2", "scatter_2", "sums_finish")


def _phases(torch, leveled, run):
    """Device ms per phase of the one-launch kernel, summed over the waves."""
    L = run.packed.n_levels
    stamps = torch.zeros(L * leveled.WAVE_STAMPS, dtype=torch.int64, device=run.device)
    run.reset()
    leveled.place_waves_cuda(run, 0, L, stamps=stamps)
    torch.cuda.synchronize()
    d = stamps.view(L, leveled.WAVE_STAMPS).diff(dim=1).sum(dim=0).cpu().tolist()
    return dict(zip(PHASES, (x / 1e6 for x in d)))


def _wall_ms(torch, fn, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    sys.path[0] = str(Path(args.root).resolve())

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_waves: no CUDA device", file=sys.stderr)
        return 2
    from distributed_tpu_torch import graphs
    from distributed_tpu_torch.ops import leveled

    report = {"root": args.root, "device": torch.cuda.get_device_name(0), "fleets": {}}
    durations, out_bytes, src, dst = graphs.random_dag(N_TASKS, seed=0)
    packed = leveled.pack_graph(durations, out_bytes, src, dst)
    for name, fleet in _fleets(np).items():
        run = leveled.LeveledRun(packed, *fleet)
        row = {"waves": packed.n_levels}
        for label, wave_fn in (("per_wave", leveled.place_wave_cuda), ("default", None)):
            def go(fn=wave_fn):
                run.reset()
                run.run_waves(fn)

            wall = _wall_ms(torch, go)
            dev, kernels = _profile(torch, go)
            row[label] = {"wall_ms": wall, "device_ms": dev, "kernels": kernels}
        if hasattr(leveled, "place_waves_cuda"):
            row["phases_ms"] = _phases(torch, leveled, run)
        report["fleets"][name] = row
        print(name, json.dumps(row), flush=True)

    if hasattr(leveled, "place_waves_cuda"):
        n = 2000
        chain = (np.ones(n, np.float32), np.full(n, 1e6, np.float32),
                 np.arange(n - 1, dtype=np.int32), np.arange(1, n, dtype=np.int32))
        cpacked = leveled.pack_graph(*chain)
        run = leveled.LeveledRun(cpacked, *_fleets(np)["uniform"])

        def go_chain():
            run.reset()
            run.run_waves()

        wall = _wall_ms(torch, go_chain)
        dev, kernels = _profile(torch, go_chain)
        report["chain"] = {"waves": cpacked.n_levels, "wall_ms": wall, "device_ms": dev,
                           "kernels": kernels, "device_us_per_wave": dev * 1e3 / cpacked.n_levels,
                           "phases_ms": _phases(torch, leveled, run)}
    text = json.dumps(report)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
