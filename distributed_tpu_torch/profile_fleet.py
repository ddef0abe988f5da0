"""Where the time of the fleet mirror's device views (K6 and K11) goes,
on the card, for one checkout or two.

Run from a checkout on a machine with one NVIDIA GPU:

    python3 distributed_tpu_torch/profile_fleet.py [--root DIR] [--out FILE]

``--root`` names the checkout whose ``distributed_tpu_torch`` and whose
``chip_smoke.py`` are used (default: the one holding this file), so one
command can time an older version beside this one's, in turns on one
card.  The mirrors are ``chip_smoke.py``'s: phase 6's 1,000 stand-in
workers (capacity 1,024) for K6's view, phase 7's fleet over the 4x2
mesh's workers axis (dw 2) for K11's.  Each view is timed by that
checkout's ``k6_view_split`` / ``k11_view_split`` at 37 dirty rows: the
whole view through the kernel, through the plain version and (where the
checkout has it) through a full upload or pack, in turns; the host
steps of a loop of views; the kernel alone; the empty launch; the bound.
Prints the card's ``nvidia-smi`` name and power limit and one JSON object.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
WORKERS = 1_000


def _smoke(root: Path):
    """``root``'s ``chip_smoke.py``: its view splits and stand-ins."""
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mirror(smoke, seed):
    """A mirror on the card over ``WORKERS`` stand-in workers with mixed
    occupancy, its rows refreshed."""
    import numpy as np
    import test_torch_periodic_cases as pc

    from distributed_tpu_torch.scheduler.mirror import TorchMirror

    state = pc.StandInState()
    mirror = state.mirror = TorchMirror(state)
    rng = np.random.default_rng(seed)
    for ws in smoke._stand_in_workers(state, WORKERS):
        ws.occupancy = float(rng.uniform(0, 4))
        mirror.mark(ws)
    mirror.refresh()
    return mirror


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path[0] = str(root)
    sys.path.insert(1, str(root / "tests"))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_fleet: no CUDA device", file=sys.stderr)
        return 2
    smoke = _smoke(root)
    from distributed_tpu_torch.ops import partition

    dev = torch.device("cuda", torch.cuda.current_device())
    card = smoke.smi_line()
    print(f"card {card}", flush=True)
    report = {"root": str(root), "card": card}
    mirror = _mirror(smoke, 70)
    mirror.device_view()
    report["k6"] = smoke.k6_view_split(card, mirror, dev, np.random.default_rng(80))
    mirror = _mirror(smoke, 71)
    mesh = smoke._shard_mesh(partition, "4x2", dev)
    mirror.sharded_device_view(mesh)
    report["k11"] = smoke.k11_view_split(card, mirror, mesh, dev, np.random.default_rng(81))
    text = json.dumps(report, default=str)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
