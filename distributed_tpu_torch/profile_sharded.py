"""Where the time of the sharded engine's wave loop (kernel K10) goes, on
the card, for one checkout or two.

Run from a checkout on a machine with one NVIDIA GPU:

    python3 distributed_tpu_torch/profile_sharded.py [--root DIR] [--out FILE]
        [--layouts 1x1,2x1,4x2,8x1]

``--root`` names the checkout whose ``distributed_tpu_torch`` is
measured (default: the one holding this file), so one command can time
another version beside this one's, in turns on one card.  The inputs are
always this checkout's, ``chip_smoke.py`` phase 7's: ``random_dag(1M,
seed=0)`` packed as phase 3 packs it, on the uniform and non-uniform
512-worker fleets, every shard on the card (``LocalShards``), every fused
run's tiles shipped first (``chip_smoke._timed_waves``).  For each fleet
and layout it reports

- ``step``: the per-wave loop of two K10 launches a wave, driven through
  the explicit pair ``(shard_tentative, shard_contend)``, with CUDA events
  around each of its six parts of every wave: launch A, the tentative
  ``psum``, launch B, the wave-load ``psum``, the two gathers and the
  replica updates (load, span, the two slice copies); each part's total
  over the waves and its median a wave (median of ``--reps`` passes), the
  waves' total by events, and :func:`idle_share`'s reading (the median
  host wall of untraced passes, the median device time of traced passes
  taken in turns with them, the idle share);
- ``default``: the loop ``ShardedRun.run_waves`` takes by its own rule
  (``body=None``), timed whole the same way (events, wall, idle share);
  ``mode`` says which loop that was
  (``shard_mode``, where the checkout has it; a checkout without it has
  only the step loop).

The step loop here mirrors ``ShardedRun.run_waves``' two-launch loop part
for part, with an event between the parts.  Prints the card's
``nvidia-smi`` name and power limit and one JSON object.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
LAYOUTS = ("1x1", "2x1", "4x2", "8x1")
PARTS = ("launch_a", "psum_tentative", "launch_b", "psum_wave_load", "gathers", "replica_updates")


def _smoke():
    """This checkout's ``chip_smoke.py``: the inputs, the card's line, the timers."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def step_waves_split(torch, run, plan, marks):
    """One pass of the two-launch loop over every fused run of ``plan``
    (``[(Fl, waves, tiles of each group)]``), as ``ShardedRun.run_waves``
    runs it, recording ``marks(part)`` after each part of each wave."""
    from distributed_tpu_torch.ops import sharded

    tentative, contend = sharded.shard_tentative, sharded.shard_contend
    comm = run.comm
    run.reset()
    for Fl, waves, tiles in plan:
        for g, t in zip(run.groups, tiles):
            g.tiles = t
            g.shape_for(Fl)
        F = Fl * run.D
        for k, w in enumerate(waves):
            offset, f = int(run.packed.offsets[w]), int(run.sizes[w])
            marks(None)
            for g in run.groups:
                tentative(g, run.replicas[g.device], k, f)
            marks("launch_a")
            tl = comm.psum(run._rows("tl_part"))
            marks("psum_tentative")
            for g in run.groups:
                contend(g, run.replicas[g.device], k, f, tl.to(g.device))
            marks("launch_b")
            wave_load = comm.psum(run._rows("wl_part"))
            marks("psum_wave_load")
            afull = comm.all_gather(run._rows("aslice"))
            cfull = comm.all_gather(run._rows("cslice"))
            marks("gathers")
            for dev, rep in run.replicas.items():
                wl = wave_load.to(dev)
                rep.load.add_(wl)
                rep.spans[w] = torch.where(rep.fleet.running, wl * rep.fleet.inv_t, 0.0).max()
                rep.assign[offset: offset + F] = afull.to(dev)
                rep.choices[offset: offset + F] = cfull.to(dev)
            marks("replica_updates")


def _split_once(torch, run, plan):
    """{part: [ms of each wave]} of one pass, from CUDA events."""
    events = []

    def marks(part):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((part, ev))

    step_waves_split(torch, run, plan, marks)
    torch.cuda.synchronize()
    out = {p: [] for p in PARTS}
    for (_, a), (part, b) in zip(events, events[1:]):
        if part is not None:
            out[part].append(a.elapsed_time(b))
    return out


def _wall_ms(torch, fn):
    """The host wall of one untraced call of ``fn``, ms: from before it to
    the synchronize after it."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def k10_launches(sharded, fn) -> int:
    """K10's launches in one call of ``fn``, both modes, by the wrappers'
    counts (a checkout before run mode has only the two-launch one)."""
    counters = [sharded.place_shard_cuda, getattr(sharded, "place_shard_run_cuda", None)]
    before = [c.launches for c in counters if c is not None]
    fn()
    return sum(c.launches for c in counters if c is not None) - sum(before)


def idle_share(torch, fn, launches, kernel="place_shard", reps=5, tries=5):
    """The card's idle share of ``fn``: 1 - the median device time of
    ``reps`` traced calls (every kernel and copy ``torch.profiler`` saw in
    each) / the median host wall of ``reps`` untraced calls (before each to
    the synchronize after it), the two kinds of call taken in turns after
    one warm-up, so both medians come from the same stretch of the run.
    ``traced_idle_share`` divides the same median device time by the
    median wall of the traced calls themselves, which holds the tracer's
    host cost.  A trace counts only if it caught all ``launches`` launches
    the caller counted of the kernels whose names hold ``kernel``; a turn
    whose ``tries`` traces all missed some raises.  Neither share is
    clamped: a negative one, median device time past its median window,
    raises.  ``chip_smoke.py`` phase 7 reads the run mode's share here."""
    from distributed_tpu_torch import profile_waves

    fn()
    torch.cuda.synchronize()
    walls, windows, device, ops, ours = [], [], [], [], []
    for _ in range(reps):
        walls.append(_wall_ms(torch, fn))
        caught = []
        for _ in range(tries):
            window = []
            times = profile_waves.kernel_times(torch, lambda: window.append(_wall_ms(torch, fn)), tries=1)
            mine = [(ms, n) for name, (ms, n) in times.items() if kernel in name]
            caught.append(sum(n for _, n in mine))
            if caught[-1] == launches:
                break
        else:
            raise RuntimeError(f"no trace caught the {launches} {kernel} launches of a call: {caught}")
        windows.append(window[0])
        device.append(sum(ms for ms, _ in times.values()))
        ops.append(sum(n for _, n in times.values()))
        ours.append(sum(ms for ms, _ in mine))
    med = statistics.median
    device_ms, wall, window_ms = med(device), med(walls), med(windows)
    out = dict(idle_share=1.0 - device_ms / wall, loop_wall_ms=wall,
               traced_idle_share=1.0 - device_ms / window_ms, window_ms=window_ms,
               device_ms=device_ms, device_ops=int(med(ops)), kernel_ms=med(ours),
               kernel_launches=launches, traced_calls=reps)
    if min(out["idle_share"], out["traced_idle_share"]) < 0:
        raise RuntimeError(f"a negative idle share: {out}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--layouts", default=",".join(LAYOUTS))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    sys.path[0] = str(Path(args.root).resolve())

    import torch

    if not torch.cuda.is_available():
        print("profile_sharded: no CUDA device", file=sys.stderr)
        return 2
    smoke = _smoke()
    from distributed_tpu_torch import graphs
    from distributed_tpu_torch.ops import leveled, partition, sharded

    dev = torch.device("cuda", torch.cuda.current_device())
    card = smoke.smi_line()
    print(f"card {card}", flush=True)
    report = {"root": args.root, "card": card, "cases": {}}
    graph = graphs.random_dag(smoke.N_TASKS, seed=0)
    packed = leveled.pack_graph(*graph, bandwidth=smoke.BANDWIDTH, latency=smoke.LATENCY)
    report["waves"] = packed.n_levels
    step_body = (sharded.shard_tentative, sharded.shard_contend)
    for name, fleet in smoke._fleets().items():
        for layout in args.layouts.split(","):
            mesh = smoke._shard_mesh(partition, layout, dev)
            row = {"n_shards": mesh.size}
            # the two-launch loop, split by part
            run, waves, plan = smoke._timed_waves(sharded, mesh, packed, fleet, body=step_body)
            _split_once(torch, run, plan)  # warm-up
            splits = [_split_once(torch, run, plan) for _ in range(args.reps)]
            parts = {}
            for p in PARTS:
                totals = [sum(s[p]) for s in splits]
                parts[p] = {"total_ms": statistics.median(totals),
                            "median_wave_ms": statistics.median(x for s in splits for x in s[p])}
            row["step"] = dict(parts=parts, events_ms=smoke.cuda_ms(waves, reps=args.reps, warmup=1),
                               split_total_ms=sum(v["total_ms"] for v in parts.values()),
                               **idle_share(torch, waves, k10_launches(sharded, waves), reps=args.reps))
            del run, waves, plan
            # the loop ShardedRun's own rule takes
            run, waves, _ = smoke._timed_waves(sharded, mesh, packed, fleet)
            mode = (sharded.shard_mode(run.comm, [g.device for g in run.groups], None)
                    if hasattr(sharded, "shard_mode") else "step")
            row["default"] = dict(mode=mode, events_ms=smoke.cuda_ms(waves, reps=args.reps, warmup=1),
                                  **idle_share(torch, waves, k10_launches(sharded, waves), reps=args.reps))
            del run, waves
            torch.cuda.empty_cache()
            report["cases"][f"{layout}_{name}"] = row
            print(f"{layout} {name}", json.dumps(row), flush=True)
    text = json.dumps(report)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
