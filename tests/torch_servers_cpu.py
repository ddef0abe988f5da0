"""CPU comparison of the port's servers and wire with the reference's.

Not a test: a script beside the test suite (it imports both packages, as
the tests do), for numbers on a machine without a card.

    JAX_PLATFORMS=cpu python tests/torch_servers_cpu.py [--G 16] [--messages 20000]

prints, for ``G``:

- the port's servers (``Scheduler(device="cpu")``, 16 one-thread workers
  over inproc, ``chip_smoke.py`` phase 14's configuration) on
  ``graphs.tensordot_graph(G)``: wall, tasks/s, the plan's counters, the
  steal and AMM paths' counters and the native engine's;
- the reference's servers (``http_port=None``, ``bench.py``'s overrides)
  on ``bench.py``'s ``_tensordot_graph(G)``: wall and tasks/s;
- dumps + loads (``deserializers=False``, no compression, best of 3) of a
  batch of ``--messages`` ``compute-task`` messages by each wire.
"""

from __future__ import annotations

import argparse
import asyncio
import importlib
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

BENCH_OVERRIDES = {"scheduler.jax.enabled": True, "scheduler.jax.min-workers": 0,
                   "scheduler.jax.min-transfer-ratio": 0}


async def port_run(G: int) -> dict:
    import chip_smoke

    def probe(s, workers):
        steal = s.extensions["stealing"]._device_path
        policies = [getattr(p, "_device_path", None) for p in s.extensions["amm"].policies]
        native = s.state.native
        return {"steal": steal.counters() if steal is not None else None,
                "amm": [p.counters() for p in policies if p is not None],
                "native": native.counters() if native is not None else None}

    return await chip_smoke._servers_graph("cpu", "inproc://", chip_smoke.SRV_WORKERS, G,
                                           chip_smoke.SRV_BLOCK, probe=probe)


async def reference_run(G: int) -> dict:
    import bench
    from distributed_tpu import config
    from distributed_tpu.client.client import Client
    from distributed_tpu.scheduler.server import Scheduler
    from distributed_tpu.worker.server import Worker

    with config.set(BENCH_OVERRIDES):
        async with Scheduler(listen_addr="inproc://", http_port=None) as s:
            workers = [await Worker(s.address, nthreads=1, http_port=None).start() for _ in range(16)]
            try:
                async with Client(s.address) as c:
                    g, outs = bench._tensordot_graph(G)
                    t0 = time.perf_counter()
                    futs = c.compute_graph(g, outs)
                    await c.gather([futs[k] for k in outs])
                    return {"wall_s": time.perf_counter() - t0, "n_tasks": len(g.tasks)}
            finally:
                for w in workers:
                    await w.close()


def wire_times(n: int) -> dict:
    out = {}
    for name, pkg in (("reference msgpack", "distributed_tpu"), ("port marshal", "distributed_tpu_torch")):
        core = importlib.import_module(f"{pkg}.protocol.core")
        ser = importlib.import_module(f"{pkg}.protocol.serialize")
        msgs = [{"op": "compute-task", "key": f"mul-{i}-{i % 7}-{i % 3}", "priority": (0, 1, i),
                 "duration": 0.5, "stimulus_id": f"update-graph-{i}",
                 "who_has": {f"Ar-{i}-0": ["inproc://x/1/2"]}, "nbytes": {f"Ar-{i}-0": 64},
                 "run_spec": ser.Serialize(b"x" * 80), "resource_restrictions": {}, "actor": False,
                 "annotations": {}, "span_id": None} for i in range(n)]
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            core.loads(core.dumps(msgs, compression=None), deserializers=False)
            best = min(best, time.perf_counter() - t0)
        out[name] = best
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--G", type=int, default=16)
    ap.add_argument("--messages", type=int, default=20_000)
    args = ap.parse_args()
    port = asyncio.run(port_run(args.G))
    print(f"port servers, tensordot_graph({args.G}), {port['n_tasks']} tasks on 16 workers (CPU): wall s "
          f"{port['wall_s']:.3f}, {port['n_tasks'] / port['wall_s']:.0f} tasks / s; plan {port['placement']}; "
          f"steal {port['steal']}; amm {port['amm']}; native {port['native']}")
    ref = asyncio.run(reference_run(args.G))
    print(f"reference servers, bench._tensordot_graph({args.G}), {ref['n_tasks']} tasks on 16 workers (CPU): "
          f"wall s {ref['wall_s']:.3f}, {ref['n_tasks'] / ref['wall_s']:.0f} tasks / s")
    for name, t in wire_times(args.messages).items():
        print(f"{name}: dumps + loads of {args.messages} compute-task messages s {t:.3f}")


if __name__ == "__main__":
    main()
