"""The port's multi-process bring-up (``parallel/multihost.py``) and the
data plane over a process group: two gloo ranks, each in its own process,
join through ``maybe_initialize`` and run ``shuffle_on_mesh``,
``ring_exchange``, ``DeviceRun.exchange`` and both long-context paths
through ``ProcessGroupShards`` (``all_to_all_single``,
``batch_isend_irecv``).

Tolerance: none.  Each rank's shard equals ``LocalShards`` at 2 shards
bit for bit: the exchanges only move data, and each shard's arithmetic is
the same calls on the same inputs.  Each rank runs torch on one thread,
under its own 120 s limit.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from distributed_tpu_torch.ops import ici, ring_attention, ulysses
from distributed_tpu_torch.parallel import multihost
from distributed_tpu_torch.shuffle import device

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)


ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("keys_out", "values_out", "counts", "sent", "ring", "run_keys", "run_values",
          "ring_attn", "ulysses")


def inputs():
    rng = np.random.default_rng(12)
    keys = rng.integers(-(1 << 31), 1 << 31, 2 * 96, dtype=np.int64).astype(np.int32)
    vals = rng.standard_normal((2 * 96, 5)).astype(np.float32)
    valid = rng.random(2 * 96) < 0.8
    x = np.arange(2 * 6, dtype=np.float32).reshape(2 * 3, 2)
    parts = [(keys[:40], vals[:40]), (keys[40:150], vals[40:150])]  # ragged
    q, k, v = (rng.standard_normal((64, 4, 8)).astype(np.float32) for _ in range(3))
    return keys, vals, valid, x, parts, (q, k, v)


def shard_results(comm, mesh, rank):
    """Everything a rank computes for shard ``rank`` (``comm`` holds it)."""
    keys, vals, valid, x, parts, qkv = inputs()
    j = comm.local.index(rank)
    ko, vo, cnt, sent = ici.shuffle_on_mesh(mesh, keys, vals, valid=valid, capacity=40, comm=comm)
    ring = ici.ring_exchange(mesh, x, comm=comm)
    run = device.DeviceRun("s", 1, 2, 2, devices=["cpu", "cpu"])
    for d in comm.local:
        run.register(d, torch.from_numpy(parts[d][0]), torch.from_numpy(parts[d][1]))
    run.exchange(max_n=max(len(p[0]) for p in parts))
    mesh_sp = ici.make_mesh_1d(2, axis="sp", devices=["cpu", "cpu"])
    ra = ring_attention.ring_attention(mesh_sp, *qkv, causal=True, comm=comm)
    ul = ulysses.ulysses_attention(mesh_sp, *qkv, comm=comm)
    return {"keys_out": ko[j], "values_out": vo[j], "counts": cnt[j], "sent": sent[j],
            "ring": ring[j], "run_keys": run.outputs[rank][0], "run_values": run.outputs[rank][1],
            "ring_attn": ra[j], "ulysses": ul[j]}


_RANK = r"""
import sys
import numpy as np, torch
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from distributed_tpu_torch.ops import ici
from distributed_tpu_torch.ops.comm import ProcessGroupShards
from distributed_tpu_torch.parallel import multihost
import test_torch_multihost as t
torch.set_num_threads(1)
rank = int(sys.argv[1])
assert multihost.maybe_initialize("localhost:{port}", rank, 2, backend="gloo")
assert multihost.maybe_initialize("localhost:{port}", rank, 2, backend="gloo")  # idempotent
try:
    assert multihost.is_multihost() and multihost.local_device_indices(2) == [rank]
    mesh = ici.make_mesh_1d(2, devices=["cpu", "cpu"])
    out = t.shard_results(ProcessGroupShards(mesh), mesh, rank)
    np.savez(sys.argv[2], **{{k: v.numpy() for k, v in out.items()}})
finally:
    import torch.distributed as dist
    dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_equal_local_shards(tmp_path):
    code = _RANK.format(root=str(ROOT), tests=str(ROOT / "tests"), port=_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(tmp_path / f"r{r}.npz")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            p.kill()
    mesh = ici.make_mesh_1d(2, devices=["cpu", "cpu"])
    for r in range(2):
        want = shard_results(ici.LocalShards(mesh), mesh, r)
        got = np.load(tmp_path / f"r{r}.npz")
        assert sorted(got.files) == sorted(FIELDS)
        for f in FIELDS:
            w = want[f].numpy()
            assert got[f].dtype == w.dtype and got[f].shape == w.shape, f
            assert np.array_equal(got[f].view(np.uint8), w.view(np.uint8)), f"rank {r} {f}"


def test_maybe_initialize_without_a_coordinator_is_a_no_op():
    assert multihost.maybe_initialize(None) is False
    assert multihost.maybe_initialize(None, 0, 2, backend="gloo") is False
    assert not multihost.is_multihost()
    assert multihost.local_device_indices(3) == [0, 1, 2]


def test_maybe_initialize_defaults_to_nccl_and_sets_the_device(monkeypatch):
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: calls.append((a, k)))
    monkeypatch.setattr(dist, "get_backend", lambda *a: "nccl")
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: calls.append(("set_device", i)))
    assert multihost.maybe_initialize("host:1234", 3, 4, local_device_ids=[2, 3])
    assert calls[0] == ("set_device", 2)
    assert calls[1] == (("nccl",), {"init_method": "tcp://host:1234", "world_size": 4, "rank": 3})
