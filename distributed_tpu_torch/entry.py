"""The port's twin of ``__graft_entry__.py``.

``entry()`` gives the flagship step: one fused run of the level-
synchronous wave kernel (K1, ``ops/csrc/place_wave.cu``; the reference's
``distributed_tpu.ops.leveled._place_run``) on the reference's tiny graph,
64 tasks onto 8 workers.  ``dryrun_multichip(n)`` runs the port's
counterpart of each section of the reference's dry run with ``n`` virtual
shards on one device (``LocalShards``): ``sharded_decide_workers`` (K15) on
a ``(tasks, workers)`` mesh, the wavefront, the sharded leveled engine
(K10) against the single-device one, ``shuffle_on_mesh`` (K12),
``DeviceRun``'s ragged exchange and ring attention (K2 a block), with the
reference's assertions.  Both run on the card unless the caller passes
``device="cpu"``.

Run both with ``python -m distributed_tpu_torch.entry [--cpu]``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from distributed_tpu_torch._device import resolve_device

ENTRY_WORKERS = 8
ENTRY_TASKS = 64
ENTRY_F = 512      # the reference's bucket: every wave of the tiny graph fits
ENTRY_K = 32       # the reference's fused waves
ENTRY_SPANS = 64   # the reference's spans buffer
RING_HEAD_DIM = 64  # the smallest head dim K2 takes on the card (the reference's dry run: 8)


def _graph(T: int, seed: int):
    """The reference's seeded random DAG: durations, output bytes and
    edges ``src -> dst``, each task depending on up to two earlier ones."""
    rng = np.random.default_rng(seed)
    durations = rng.uniform(0.01, 1.0, T).astype(np.float32)
    out_bytes = rng.uniform(1e3, 1e6, T).astype(np.float32)
    src, dst = [], []
    for t in range(1, T):
        for d in rng.integers(0, t, rng.integers(0, 3)):
            src.append(int(d))
            dst.append(t)
    return durations, out_bytes, np.asarray(src, np.int32), np.asarray(dst, np.int32)


def _pad(t: torch.Tensor, n: int, fill) -> torch.Tensor:
    out = torch.full((n,), fill, dtype=t.dtype, device=t.device)
    out[: t.numel()] = t
    return out


def entry(device=None):
    """``(fn, example_args)``: ``fn(*example_args)`` places the tiny graph
    in one launch of K1 (the plain wave a level at a time on the CPU) and
    returns the reference's four outputs in its shapes: ``assign`` and
    ``choices`` i32 ``[T + F]`` in level-sorted order (-1 and 2 past the
    graph), ``load`` f32 ``[W]``, ``spans`` f32 ``[64]`` (0 past the last
    wave).  ``example_args`` is the run, its wire and fleet on the device;
    each call starts from its initial state."""
    from distributed_tpu_torch.ops.leveled import LeveledRun, pack_graph, place_waves

    W, T = ENTRY_WORKERS, ENTRY_TASKS
    packed = pack_graph(*_graph(T, 0))
    if packed.n_levels > ENTRY_K or np.diff(packed.offsets).max() > ENTRY_F:
        raise ValueError("the tiny graph outgrew the reference's one fused run")
    run = LeveledRun(packed, np.full(W, 2, np.int32), np.zeros(W, np.float32),
                     np.ones(W, bool), device=device)

    def step(run):
        run.reset()
        place_waves(run, 0, run.packed.n_levels)
        Tp = run.packed.n + ENTRY_F
        return (_pad(run.assign, Tp, -1), _pad(run.choices, Tp, 2), run.load.clone(),
                _pad(run.spans, ENTRY_SPANS, 0.0))

    return step, (run,)


def _check(cond, msg) -> None:
    if not cond:
        raise AssertionError(msg)


def dryrun_multichip(n_devices: int, device=None) -> str:
    """The reference's dry run on ``n_devices`` virtual shards of one
    device, every assertion kept; the sharded engine must equal the
    single-device one bit for bit (the reference asks for 99 % of the
    assignment).  Returns the summary line it prints.  Needs no process
    group: with one, the shuffle's shards would be this rank's only."""
    from distributed_tpu_torch.ops.flash import reference_attention
    from distributed_tpu_torch.ops.ici import compact_shuffle_output, make_mesh_1d, shuffle_on_mesh
    from distributed_tpu_torch.ops.leveled import pack_graph, place_graph_leveled
    from distributed_tpu_torch.ops.partition import make_engine_mesh
    from distributed_tpu_torch.ops.placement import WorkerArrays, build_batch_arrays
    from distributed_tpu_torch.ops.ring_attention import ring_attention
    from distributed_tpu_torch.ops.wavefront import GraphArrays, place_graph
    from distributed_tpu_torch.parallel.mesh import (
        make_mesh,
        place_graph_leveled_sharded,
        sharded_decide_workers,
    )
    from distributed_tpu_torch.shuffle.device import DeviceRun

    dev = resolve_device(device)
    devices = [dev] * n_devices
    mesh = make_mesh(n_devices, devices=devices)
    dt, dw = mesh.dt, mesh.dw

    # the round-1 batch on the (tasks, workers) mesh (K15)
    W = 16 * dw
    B_target = 32 * dt
    rng = np.random.default_rng(0)
    workers = WorkerArrays(
        nthreads=np.full(W, 2, np.int32),
        occupancy=rng.uniform(0, 1, W).astype(np.float32),
        nbytes=rng.uniform(0, 1e8, W).astype(np.float32),
        running=np.ones(W, bool),
    ).to(dev)
    D, E = 16, 64
    durations = rng.uniform(0.01, 1.0, B_target).astype(np.float32)
    dep_bytes = rng.uniform(1e3, 1e7, D).astype(np.float32)
    has = rng.random((D, W)) < 0.3
    edge_task = rng.integers(0, B_target, E)
    edge_dep = rng.integers(0, D, E)
    batch = build_batch_arrays(durations, (edge_task, edge_dep), dep_bytes, has, bucket=False,
                               device=dev)
    _check(batch.duration.shape[0] % dt == 0, "batch rows do not divide the tasks axis")
    a = sharded_decide_workers(mesh, workers, batch, bandwidth=100e6).cpu().numpy()
    _check(a.shape[0] == batch.duration.shape[0], "assignment length")
    _check((a[:B_target] >= 0).all(), "sharded placement produced unplaced tasks")
    _check((a[:B_target] < W).all(), "sharded placement named a worker past the fleet")

    # the wavefront on the same device
    T = 8 * dt * dw
    dur_g, ob_g, src_g, dst_g = _graph(T, 0)
    g = GraphArrays.from_arrays(dur_g, ob_g, src_g.astype(np.int64), dst_g.astype(np.int64),
                                pad_tasks=T + 8, pad_edges=max(len(src_g) + 8, 16), device=dev)
    res = place_graph(g, workers.nthreads, torch.zeros(W, device=dev), workers.running,
                      bandwidth=100e6)
    valid = g.valid.cpu().numpy()
    _check((res.assignment.cpu().numpy()[valid] >= 0).all(), "the wavefront left tasks unplaced")

    # the sharded leveled engine (K10, run mode) against the single-device one (K1)
    Tl = 64 * n_devices
    packed = pack_graph(*_graph(Tl, 3))
    fleet = (np.full(W, 2, np.int32), np.zeros(W, np.float32), np.ones(W, bool))
    mesh_lv = make_engine_mesh(layout=f"{n_devices}x1", devices=devices)
    a_sh, load_sh = place_graph_leveled_sharded(mesh_lv, packed, *fleet)
    single = place_graph_leveled(packed, *fleet, device=dev)
    _check((a_sh >= 0).all() and (a_sh < W).all(), "the sharded engine left tasks unplaced")
    _check(np.array_equal(a_sh, single.assignment)
           and np.array_equal(np.asarray(load_sh).view(np.uint32),
                              np.asarray(single.occupancy).view(np.uint32)),
           "the sharded engine diverged from the single-device engine")

    # the data plane: a hash shuffle over the mesh (K12)
    mesh1d = make_mesh_1d(n_devices, devices=devices)
    rngk = np.random.default_rng(1)
    n_rows = n_devices * 32
    skeys = rngk.integers(0, 1 << 30, n_rows).astype(np.int32)
    svals = rngk.random((n_rows, 4)).astype(np.float32)
    ko, vo, counts, _sent = shuffle_on_mesh(mesh1d, skeys, svals)
    parts = compact_shuffle_output(ko, vo, counts, n_devices)
    _check(sum(len(k) for k, _ in parts) == n_rows, "the mesh shuffle lost rows")

    # the device shuffle's ragged exchange, outputs on their shards' devices
    drun = DeviceRun("dryrun-devshuffle", 1, n_devices, n_devices, devices=devices)
    rngd = np.random.default_rng(4)
    total = 0
    for d in range(n_devices):
        n = 16 + 8 * d  # ragged on purpose
        total += n
        drun.register(d, torch.from_numpy(rngd.integers(0, 1 << 30, n).astype(np.int32)).to(dev),
                      torch.from_numpy(rngd.random((n, 2)).astype(np.float32)).to(dev))
    drun.exchange(max_n=max(16 + 8 * d for d in range(n_devices)))
    _check(drun.outputs is not None, "the exchange gave no outputs")
    _check(drun.local_ids == list(range(n_devices)), f"local shards {drun.local_ids}")
    got = 0
    for d in range(n_devices):
        ok, _ov = drun.outputs[d]
        _check(ok.device == devices[d], f"shard {d}'s output on {ok.device}")
        got += int(ok.shape[0])
    _check(got == total, f"the exchange moved {got} rows of {total}")

    # ring attention with the sequence over the mesh, against the whole-sequence oracle
    seq, H = n_devices * 16, 2
    rq = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rq.standard_normal((seq, H, RING_HEAD_DIM)).astype(np.float32))
               for _ in range(3))
    ring_mesh = make_mesh_1d(n_devices, axis="sp", devices=devices)
    att = torch.cat([x.cpu() for x in ring_attention(ring_mesh, q.to(dev), k.to(dev), v.to(dev),
                                                     axis="sp", causal=True)])
    want = reference_attention(q, k, v, causal=True)
    np.testing.assert_allclose(att.numpy(), want.numpy(), rtol=5e-4, atol=5e-4)

    line = (f"dryrun_multichip ok: mesh {dt}x{dw} (tasks x workers), "
            f"batch {batch.duration.shape[0]}, workers {W}, waves {int(res.n_waves)}, "
            f"mesh shuffle {n_rows} rows over {n_devices} shards, "
            f"device shuffle {total} ragged rows resident end-to-end, "
            f"sharded leveled engine {Tl} tasks bit for bit with single-device, "
            f"ring attention seq {seq} over {n_devices} shards, on {dev}")
    print(line)
    return line


def main(argv: list[str]) -> int:
    device = "cpu" if "--cpu" in argv else None
    dryrun_multichip(8, device=device)
    fn, args = entry(device=device)
    assign, choices, load, spans = fn(*args)
    print("entry ok:", tuple(assign.shape), tuple(choices.shape), tuple(load.shape),
          tuple(spans.shape))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
