"""Where the time of the balance plan (K7), the AMM drop plan (K8) and the
rebalance plan (K9) goes, on the card, for one checkout or two.

Run from a checkout on a machine with one NVIDIA GPU:

    python3 distributed_tpu_torch/profile_periodic.py [--root DIR] [--out FILE]

``--root`` names the checkout whose ``distributed_tpu_torch`` is
measured (default: the one holding this file), so one command can time
another version beside this one's, in turns on one card.  The inputs are
always this checkout's, ``chip_smoke.py`` phase 6's, made by
``tests/test_torch_periodic_cases.py``: the balance cycles (8,192 tasks
on 32 victims, 8 rounds, on ``fleet512`` and ``fleet1000``, the fleet
padded to the mirror's capacity as its view is), the AMM round (16,384
replicated keys on 512 workers, 2-64 holders a key, seed 62, the rounds
padded to 64) and the rebalance (262,144 single-replica keys on 512
workers, seed 63).  It reports

- ``k7``, for each fleet: ``ms``, one ``steal_rounds_cuda`` call by CUDA
  events (median of 10, as phase 6 times it); ``phases``, the kernel's
  own timeline (``stamps``) split by phase, each phase's median over the
  rounds and its total over the rounds (median of 5 calls), where the
  kernel under ``--root`` keeps one; ``digest``, of the thieves and the
  occupancy;
- ``k8_ms``: one ``drop_rounds_cuda`` call by CUDA events (median of 10),
  and the same with the rounds cut to 1 and 8 (``k8_ms_rounds``: the
  first rounds have the most rows left to drop); ``k8_rounds_with_drops``,
  the rounds that dropped anything (the kernel stops after the first
  round that drops nothing); ``k8_phases``, its timeline split as K7's
  (``first_ms`` is the prologue); ``k8_kernels``, from ``torch.profiler``
  over one call, the device time and count of every kernel it ran;
  ``k8_digest``, of the drops and the memory;
- ``k9`` and ``k9_wide``: K9 on phase 6's two cases (``REBALANCE_WORKERS``
  and ``REBALANCE_WIDE`` workers), through ``chip_smoke.k9_entry`` as
  phase 6 checks and times it (bit for bit against the plain version on
  the card and against itself; events ms, device time, bound, timeline
  split, digest of the moves), so the checkout under ``--root`` must
  return K9's moves in the compact form (``rebalance.Rounds``);
  ``k9_plan_ms``, the whole ``plan_rebalance`` on the host clock (median
  of 3), with its moves and their digest;
- ``python_plan_ms``: the reference scheduler's host plan (its copy,
  ``rebalance_plan_python`` in the same test module) on the same keys,
  host clock, median of 3, with its moves;

with the card's ``nvidia-smi`` name and power limit, as one JSON object.
``--skip-k9`` leaves K9 and the host plan out; ``--k9-only`` times K9
alone.
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
K8_ROUNDS = 64


def _smoke():
    """This checkout's ``chip_smoke.py``, for the card's line and the cases."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(*arrays) -> str:
    return hashlib.blake2b(b"".join(a.tobytes() for a in arrays), digest_size=8).hexdigest()


def phase_split(stamps, phases, first: int = 1) -> dict:
    """A kernel timeline split by phase, in ms: ``stamps`` holds the start,
    ``first - 1`` more marks, then a mark at the end of each of the
    ``phases`` of each round (0 for a round that did not run).  Returns the
    rounds that ran, ``first_ms`` (the start to the last of the first
    marks) and for each phase the median over the rounds and the total."""
    t = [int(x) for x in stamps]
    n = len(phases)
    body = t[first:]
    rounds = [body[i:i + n] for i in range(0, len(body) - n + 1, n)]
    rounds = [r for r in rounds if all(r)]
    per, prev = [], t[first - 1]
    for r in rounds:
        per.append([(b - a) / 1e6 for a, b in zip([prev, *r[:-1]], r)])
        prev = r[-1]
    out = {"rounds": len(per), "first_ms": (t[first - 1] - t[0]) / 1e6}
    for name, col in zip(phases, zip(*per)):
        out[name] = {"median_ms": statistics.median(col), "total_ms": sum(col)}
    return out


def kernel_timeline(torch, fn, n_stamps, phases, first=1, reps=5):
    """``phase_split`` of ``fn(stamps)``'s timeline, each number the median
    of ``reps`` calls after a warm-up."""
    stamps = torch.zeros(n_stamps, dtype=torch.int64, device="cuda")
    runs = []
    for _ in range(reps + 1):
        stamps.zero_()
        fn(stamps)
        runs.append(phase_split(stamps.cpu().tolist(), phases, first))
    runs = runs[1:]
    out = {"rounds": runs[0]["rounds"],
           "first_ms": statistics.median(r["first_ms"] for r in runs)}
    for name in phases:
        out[name] = {k: statistics.median(r[name][k] for r in runs)
                     for k in ("median_ms", "total_ms")}
    return out


def _has_stamps(fn) -> bool:
    return "stamps" in inspect.signature(fn).parameters


def _host_ms(fn, reps):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--out", default=None, help="also write the JSON here")
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--skip-k9", action="store_true", help="time K7 and K8 only")
    group.add_argument("--k9-only", action="store_true", help="time K9 only, without the host plan")
    args = ap.parse_args(argv)
    sys.path[0] = str(Path(args.root).resolve())
    sys.path.insert(1, str(HERE / "tests"))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_periodic: no CUDA device", file=sys.stderr)
        return 2
    smoke = _smoke()
    import test_torch_periodic_cases as cases

    from distributed_tpu_torch.ops import amm, rebalance, stealing
    from distributed_tpu_torch.profile_waves import kernel_times

    dev = torch.device("cuda", 0)
    report = {"root": args.root, "card": smoke.smi_line()}

    if not args.k9_only:
        # K7, on both of phase 6's fleets
        steal_rounds = inspect.signature(stealing.plan_steals).parameters["rounds"].default
        report["k7"] = {}
        for name, _ in smoke.STEAL_FLEETS:
            batch, fleet = smoke.steal_case(cases, name)
            k7_args = smoke._padded_steal(stealing, batch, fleet, dev)
            thief_of, occ = stealing.steal_rounds_cuda(*k7_args, steal_rounds)
            entry = {"T": len(k7_args[0]), "W": len(k7_args[4]),
                     "ms": smoke.cuda_ms(lambda: stealing.steal_rounds_cuda(*k7_args, steal_rounds)),
                     "digest": _digest(thief_of.cpu().numpy(), occ.cpu().numpy())}
            if _has_stamps(stealing.steal_rounds_cuda):
                entry["phases"] = kernel_timeline(
                    torch, lambda st: stealing.steal_rounds_cuda(*k7_args, steal_rounds, stamps=st),
                    1 + steal_rounds * len(stealing.STEAL_PHASES), stealing.STEAL_PHASES)
            report["k7"][name] = entry

        # K8
        batch = cases.drop_round(np.random.default_rng(62), smoke.AMM_KEYS, smoke.AMM_WORKERS)
        k8_args = [torch.from_numpy(np.asarray(a)).to(dev) for a in batch]
        drops, mem = amm.drop_rounds_cuda(*k8_args, K8_ROUNDS)
        drops, mem = drops.cpu().numpy(), mem.cpu().numpy()
        ms = {k: smoke.cuda_ms(lambda k=k: amm.drop_rounds_cuda(*k8_args, k)) for k in (1, 8, K8_ROUNDS)}
        kernels = kernel_times(torch, lambda: amm.drop_rounds_cuda(*k8_args, K8_ROUNDS))
        report.update(
            k8_case=f"{smoke.AMM_KEYS}x{smoke.AMM_WORKERS}", k8_ms=ms[K8_ROUNDS], k8_ms_rounds=ms,
            k8_rounds_with_drops=int((drops >= 0).any(axis=0).sum()),
            k8_kernels={name: {"ms": t, "count": n} for name, (t, n) in kernels.items()},
            k8_digest=_digest(drops, mem),
        )
        if _has_stamps(amm.drop_rounds_cuda):
            report["k8_phases"] = kernel_timeline(
                torch, lambda st: amm.drop_rounds_cuda(*k8_args, K8_ROUNDS, stamps=st),
                2 + K8_ROUNDS * len(amm.DROP_PHASES), amm.DROP_PHASES, first=2)
    if args.skip_k9:
        return _emit(report, args.out)

    # K9 on phase 6's two cases, and the host plan the scheduler's gate
    # takes below 512 candidates
    N, sm_mhz = smoke.REBALANCE_KEYS, smoke.sm_clock_mhz()
    reb = cases.rebalance_case(np.random.default_rng(63), N, smoke.REBALANCE_WORKERS)
    report["k9"] = smoke.k9_entry(rebalance, reb, dev, sm_mhz)
    wide = cases.rebalance_case(np.random.default_rng(63), N, smoke.REBALANCE_WIDE)
    report["k9_wide"] = smoke.k9_entry(rebalance, wide, dev, sm_mhz)
    plan_ms, moves = _host_ms(lambda: rebalance.plan_rebalance(reb, device=dev), 3)
    report.update(k9_plan_ms=plan_ms, k9_plan_moves=len(moves),
                  k9_plan_digest=_digest(np.asarray(moves, np.int64)))
    if not args.k9_only:
        wss, _ = cases.rebalance_fleet(reb)
        py_ms, py_moves = _host_ms(lambda: cases.rebalance_plan_python(wss, None), 3)
        report.update(python_plan_ms=py_ms, python_moves=len(py_moves))
    return _emit(report, args.out)


def _emit(report, out) -> int:
    text = json.dumps(report)
    print(text)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
