"""The port's shuffle storage and fault tolerance
(``distributed_tpu_torch/shuffle/buffers.py``, ``core.py``,
``scheduler_ext.py``) against the reference's, on the CPU: the cases of
``tests/test_shuffle_storage.py`` on both packages, with the same seeded
inputs.

Tolerance: none.  The buffers give back what was written, and the disk
buffer's spill files are the reference's byte for byte; ``p2p_merge`` and a
shuffle through a 4 kB shard budget give the reference cluster's outputs
bit for bit; a worker closed mid-shuffle, a duplicate output fetch and a
dependency-free unpack on a one-thread worker each end with the reference's
rows and epochs.  The port's buffers size a CUDA tensor by its device bytes
(``utils/sizeof.py``), shown on the meta device.
"""

from __future__ import annotations

import asyncio
import os
import time as _time

import numpy as np
import pytest
import torch

from distributed_tpu.shuffle import buffers as ref_buffers
from distributed_tpu_torch.shuffle import buffers

from conftest import gen_test
from torch_shuffle_cases import (
    PACKAGES,
    big_partition,
    cluster_and_client,
    left_part,
    outer_left,
    outer_right,
    right_part,
)

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)

MODULES = {"reference": ref_buffers, "port": buffers}


# ------------------------------------------------------------------ buffers


@gen_test()
async def test_resource_limiter_blocks_until_released():
    """The limiter books past its limit, blocks the next acquire until the
    budget is released and ends at zero, in both packages alike."""
    out = {}
    for name, mod in MODULES.items():
        lim = mod.ResourceLimiter(100)
        await lim.acquire(80)
        await lim.acquire(30)  # an oversized last acquire goes through
        steps = [lim.free(), lim.acquired]
        blocked = asyncio.create_task(lim.acquire(10))
        await asyncio.sleep(0.05)
        steps.append(blocked.done())
        lim.release(80)
        lim.release(30)
        await asyncio.wait_for(blocked, 1)
        lim.release(10)
        lim.release(5)  # below zero: clamped
        out[name] = steps + [lim.acquired, repr(lim)]
    assert out["port"] == out["reference"] == [False, 110, False, 0, "<ResourceLimiter 0/100>"]


@gen_test()
async def test_memory_buffer_roundtrip_equals_reference():
    """Shards come back per partition in write order, as the reference's."""
    out = {}
    for name, mod in MODULES.items():
        buf = mod.MemoryShardsBuffer()
        await buf.write({1: ["a", "b"], 2: ["c"]})
        await buf.write({1: ["d"], 4: []})
        out[name] = [await buf.read(1), await buf.read(2), await buf.read(3), buf.bytes_total]
        await buf.close()
    assert out["port"] == out["reference"]
    assert out["port"][:3] == [["a", "b", "d"], ["c"], []]


def _spill_writes():
    rng = np.random.default_rng(5)
    return [{0: [(0, rng.standard_normal(1000))], 7: [(1, "x")]},
            {7: [(2, "y")], 3: [(4, {"key": np.arange(50), "value": rng.random(50)})]},
            {0: [(5, np.arange(16, dtype=np.int32))]}]


@gen_test()
async def test_disk_buffer_files_equal_reference_byte_for_byte(tmp_path):
    """The disk buffer's spill files are the reference's byte for byte
    (protocol-5 pickles with their buffers as length-prefixed frames), and
    read back to the same shards, writable, on both."""
    files, back = {}, {}
    for name, mod in MODULES.items():
        directory = str(tmp_path / name)
        buf = mod.DiskShardsBuffer(directory)
        for w in _spill_writes():
            await buf.write(w)
        await buf.flush()
        files[name] = {f: open(os.path.join(directory, f), "rb").read()
                       for f in sorted(os.listdir(directory))}
        got = {j: await buf.read(j) for j in (0, 3, 7, 9)}
        arr = got[0][0][1]
        assert arr.flags.writeable
        arr += 1  # a consumer may mutate a spilled shard in place
        back[name] = repr(got)
        await buf.close()
        assert not os.path.exists(directory)
    assert sorted(files["port"]) == ["0.shards", "3.shards", "7.shards"]
    assert files["port"] == files["reference"]
    assert back["port"] == back["reference"]


@gen_test()
async def test_disk_buffer_backpressure_completes_as_the_reference(tmp_path):
    """A 2 kB budget far under the data: writers block and drain, never
    fail, and every shard comes back."""
    out = {}
    for name, mod in MODULES.items():
        lim = mod.ResourceLimiter(2_000)
        buf = mod.DiskShardsBuffer(str(tmp_path / name), limiter=lim)
        for i in range(50):
            await buf.write({i % 5: [(i, np.full(500, i))]})
        await buf.flush()
        out[name] = (lim.acquired, [[t for t, _ in await buf.read(j)] for j in range(5)])
        await buf.close()
    assert out["port"] == out["reference"]
    assert out["port"][0] == 0 and sum(map(len, out["port"][1])) == 50


@gen_test()
async def test_comm_buffer_splits_batches_as_the_reference():
    """``message_bytes_limit`` splits a backed-up bucket into the
    reference's sends."""
    out = {}
    for name, mod in MODULES.items():
        sent = []

        async def send(addr, shards, sent=sent):
            sent.append((addr, [tag for _, tag, _ in shards]))

        buf = mod.CommShardsBuffer(send=send, message_bytes_limit=2_500)
        await buf.write({"w1": [(0, i, np.zeros(100)) for i in range(7)], "w2": [(1, 9, "x")]})
        await buf.flush()
        await buf.close()
        out[name] = sorted(sent)
    assert out["port"] == out["reference"]
    assert len(out["port"]) > 2


def test_a_cuda_shard_counts_its_device_bytes():
    """The port's buffers size a tensor by its bytes through the port's
    ``sizeof``, wherever it lives (here the meta device: no memory)."""
    t = torch.empty(1 << 20, 4, device="meta")
    assert buffers._nbytes(t) >= (1 << 20) * 16
    assert buffers._nbytes([(0, t)]) >= (1 << 20) * 16


# ------------------------------------------------------------------ live


@gen_test(timeout=120)
async def test_shuffle_through_a_4kb_budget_equals_reference():
    """With a 4 kB shard budget every shard spills through disk, and the
    outputs equal the reference cluster's bit for bit."""
    out = {}
    for pkg in PACKAGES:
        with pkg.config.set({"shuffle.memory-limit": "4kB", "shuffle.disk": True}):
            async with cluster_and_client(pkg, 3) as (cluster, c):
                inputs = [c.submit(big_partition, i, key=f"in-{i}") for i in range(6)]
                await c.gather(inputs)
                outs = await pkg.shuffle.p2p_shuffle(c, inputs, npartitions_out=4)
                out[pkg.name] = await asyncio.wait_for(c.gather(outs), 60)
                for w in cluster.workers:
                    for run in w.shuffle.runs.values():
                        assert isinstance(run.store, pkg.buffers.DiskShardsBuffer)
    assert out["port"] == out["reference"]
    assert sorted(x for p in out["port"] for x in p) == sorted(
        x for i in range(6) for x in big_partition(i))


@pytest.mark.parametrize("how", ["inner", "outer"])
@gen_test(timeout=120)
async def test_p2p_merge_equals_reference(how):
    """``p2p_merge`` joins (key, ...) records into the reference's output
    partitions, record for record and in order."""
    out = {}
    for pkg in PACKAGES:
        async with cluster_and_client(pkg, 2) as (cluster, c):
            if how == "inner":
                left = [c.submit(left_part, i, key=f"L-{i}") for i in range(3)]
                right = [c.submit(right_part, i, key=f"R-{i}") for i in range(2)]
                n_out = 3
            else:
                left = [c.submit(outer_left, key="L-0")]
                right = [c.submit(outer_right, key="R-0")]
                n_out = 2
            await c.gather(left + right)
            outs = await pkg.shuffle.p2p_merge(c, left, right, npartitions_out=n_out, how=how)
            out[pkg.name] = await asyncio.wait_for(c.gather(outs), 60)
    assert out["port"] == out["reference"]
    if how == "outer":
        assert sorted(t for p in out["port"] for t in p) == [
            (1, (1, "a"), None), (2, (2, "b"), (2, "x")), (3, None, (3, "y"))]


@gen_test(timeout=180)
async def test_worker_closed_mid_shuffle_restarts_as_the_reference():
    """Closing an output owner mid-shuffle bumps the epoch, moves its
    outputs to the survivors and gives the reference's outputs."""
    out = {}
    for pkg in PACKAGES:
        async with cluster_and_client(pkg, 3) as (cluster, c):
            ext = cluster.scheduler.extensions["shuffle"]
            inputs = [c.submit(big_partition, i, key=f"in-{i}") for i in range(4)]
            await c.gather(inputs)
            outs = await pkg.shuffle.p2p_shuffle(c, inputs, npartitions_out=4)
            for _ in range(2000):
                if ext.active:
                    break
                await asyncio.sleep(0.01)
            assert ext.active, "shuffle never registered"
            sid = next(iter(ext.active))
            victim_addr = ext.active[sid].worker_for[0]
            victim = next(w for w in cluster.workers if w.address == victim_addr)
            await victim.close()
            cluster.workers.remove(victim)
            results = await asyncio.wait_for(c.gather(outs), 150)
            st = ext.active[sid]
            out[pkg.name] = (st.run_id >= 2, victim_addr in set(st.worker_for.values()), results)
    assert out["port"] == out["reference"]
    assert out["port"][:2] == (True, False)


async def _refetch_partition_0(pkg, c, cluster, n_out):
    """Finish a shuffle, forget output 0, and run its unpack again under the
    finished epoch; returns the rows it gives and the epochs."""
    ext = cluster.scheduler.extensions["shuffle"]
    inputs = [c.submit(big_partition, i, key=f"in-{i}") for i in range(4)]
    await c.gather(inputs)
    outs = await pkg.shuffle.p2p_shuffle(c, inputs, npartitions_out=n_out)
    await asyncio.wait_for(c.gather(outs), 60)
    sid = next(iter(ext.active))
    st = ext.active[sid]
    run_before = st.run_id
    key0 = outs[0].key
    outs[0].release()
    for _ in range(100):
        if key0 not in cluster.scheduler.state.tasks:
            break
        await asyncio.sleep(0.05)
    t0 = _time.monotonic()
    futs = c._graph_to_futures(
        {key0: pkg.TaskSpec(pkg.api.shuffle_unpack, (sid, 0, run_before))}, [key0])
    part = await asyncio.wait_for(futs[key0].result(), 90)
    return part, run_before, st.run_id, _time.monotonic() - t0


@gen_test(timeout=120)
async def test_duplicate_output_fetch_restarts_as_the_reference():
    """An unpack of a partition already served restarts the epoch and
    gives the partition's real rows, as in the reference."""
    out = {}
    for pkg in PACKAGES:
        async with cluster_and_client(pkg, 2) as (cluster, c):
            part, before, after, _ = await _refetch_partition_0(pkg, c, cluster, 4)
            out[pkg.name] = (part, after > before)
    want = [x for i in range(4) for x in big_partition(i) if x % 4 == 0]
    assert out["port"] == out["reference"]
    assert sorted(out["port"][0]) == sorted(want) and out["port"][1]


@gen_test(timeout=120)
async def test_dep_free_unpack_cannot_wedge_a_one_thread_worker():
    """A recomputed unpack with no dependencies on a one-thread worker
    secedes while it waits for the barrier, so the transfers queued behind
    it run: the rows are the reference's, well inside the 30 s timeout."""
    out = {}
    for pkg in PACKAGES:
        async with cluster_and_client(pkg, 1) as (cluster, c):
            part, before, after, elapsed = await _refetch_partition_0(pkg, c, cluster, 2)
            assert elapsed < 25, f"{pkg}: the unpack took {elapsed:.1f} s: the worker wedged"
            out[pkg.name] = (part, after > before)
    want = [x for i in range(4) for x in big_partition(i) if x % 2 == 0]
    assert out["port"] == out["reference"]
    assert sorted(out["port"][0]) == sorted(want)
