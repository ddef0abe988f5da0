"""The port's spill buffer and worker memory manager (``worker/spill.py``,
``worker/memory.py``) against the reference's, on the CPU.

The same seeded sequence of sets, gets, evictions, overwrites and deletes
goes through both ``SpillBuffer``s: after each step the fast and slow key
orders, the byte counts, the spill counts and the files on disk must be
equal.  On numpy arrays both pickle alike, so the files' bytes are equal
too.  On torch CPU tensors the port's buffer is held against the
reference's on numpy arrays of the same bytes: the port's ``sizeof``
counts a tensor's element bytes as the reference counts an array's, but
torch pickles a tensor in its own format, so there the slow layer's byte
counts are the port's file sizes and the values come back equal.  Then
live clusters: a worker spills to its target and serves spilled data, a
paused worker stops executing, and the memory manager's pause and
unpause thresholds (a stand-in RSS) give the reference's outcome.  A
tensor evicted from a live worker is freed: nothing else holds it.

The RSS thresholds are off in the cluster tests (``worker.memory.spill``
and ``pause`` False): this process's RSS, with JAX and torch loaded, is
far above the small limits that make a worker spill.
"""

from __future__ import annotations

import asyncio
import builtins
import gc
import os
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from distributed_tpu import config as ref_config
from distributed_tpu.client.client import Client as RefClient
from distributed_tpu.deploy.local import LocalCluster as RefLocalCluster
from distributed_tpu.worker import memory as ref_memory
from distributed_tpu.worker.spill import SpillBuffer as RefSpillBuffer
from distributed_tpu_torch import config as port_config
from distributed_tpu_torch.client.client import Client
from distributed_tpu_torch.deploy.local import LocalCluster
from distributed_tpu_torch.utils.misc import seq_name
from distributed_tpu_torch.worker import memory
from distributed_tpu_torch.worker.spill import SpillBuffer

from conftest import gen_test

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)

RSS_OFF = {"worker.memory.spill": False, "worker.memory.pause": False}


def _ops(seed: int, n: int = 60):
    """A seeded sequence of buffer operations over ten keys."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        kind = rng.choice(["set", "set", "get", "evict", "del"])
        ops.append((str(kind), f"k{rng.integers(10)}", int(rng.integers(1, 4000)),
                    int(rng.integers(1 << 30))))
    return ops


def _array(size: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 255, size, dtype=np.uint8)


def _step(buf, op, make):
    """One operation; returns what the caller sees (a value's bytes, a
    freed count, or the error)."""
    kind, key, size, seed = op
    try:
        if kind == "set":
            buf[key] = make(_array(size, seed))
            return None
        if kind == "get":
            return np.asarray(buf[key]).tobytes()
        if kind == "evict":
            return buf.evict()
        del buf[key]
        return None
    except KeyError as e:
        return ("KeyError", e.args)


def _snapshot(buf, files_too: bool):
    files = sorted(os.listdir(buf.spill_directory))
    snap = [list(buf.fast), list(buf.slow), buf.fast_bytes, buf.spilled_count,
            buf.unspilled_count, files, dict(buf.fast_sizes)]
    if files_too:
        snap += [buf.slow_bytes, dict(buf.slow),
                 [open(os.path.join(buf.spill_directory, f), "rb").read() for f in files]]
    return snap


@pytest.mark.parametrize("target", [0, 6_000], ids=["unbounded", "target"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_the_buffer_gives_the_references_orders_bytes_and_files(tmp_path, kind, seed, target):
    ref = RefSpillBuffer(str(tmp_path / "ref"), target=target)
    port = SpillBuffer(str(tmp_path / "port"), target=target)
    as_port = (lambda a: a) if kind == "numpy" else torch.from_numpy
    try:
        for op in _ops(seed):
            want = _step(ref, op, lambda a: a)
            got = _step(port, op, as_port)
            if op[0] == "evict" and kind == "torch":
                # the freed count is sizeof's, equal; -1 alike when nothing is left
                assert got == want
            else:
                assert got == want, op
            assert _snapshot(port, kind == "numpy") == _snapshot(ref, kind == "numpy"), op
            if kind == "torch":
                # the slow layer counts the port's own files' bytes
                sizes = {k: os.path.getsize(port._path(k)) for k in port.slow}
                assert port.slow == sizes and port.slow_bytes == sum(sizes.values())
                assert all(isinstance(v, torch.Tensor) for v in port.fast.values())
        assert port.spilled_count > 0 and port.unspilled_count > 0
    finally:
        ref.close()
        port.close()
    assert not os.path.exists(port.spill_directory)


def test_a_tensor_comes_back_equal_with_its_dtype_and_shape(tmp_path):
    buf = SpillBuffer(str(tmp_path / "spill"))
    g = torch.Generator().manual_seed(0)
    values = {"f64": torch.randn(17, 3, generator=g, dtype=torch.float64),
              "bf16": torch.randn(64, generator=g).to(torch.bfloat16),
              "i32": torch.randint(-9, 9, (5, 5), generator=g, dtype=torch.int32),
              "view": torch.arange(40.0).reshape(8, 5)[::2, 1:]}
    for k, v in values.items():
        buf[k] = v
    while buf.evict() >= 0:
        pass
    assert sorted(buf.slow) == sorted(values) and not buf.fast
    for k, v in values.items():
        back = buf[k]
        assert back.dtype == v.dtype and back.shape == v.shape and back.device == v.device
        assert torch.equal(back, v)
    buf.close()


# ------------------------------------------------------------ live clusters


def payload(n):
    return b"payload" * n


def block(i, n=12_500):
    """``n`` f64 of value ``i``: 100 kB at the default ``n``."""
    return np.full(n, float(i))


def tensor_block(i, n=12_500):
    return torch.full((n,), float(i), dtype=torch.float64)


def total(x):
    return float(x.sum())


def eleven():
    return 11


def _new_cluster(pkg, **worker_kwargs):
    kw = dict(n_workers=1, scheduler_kwargs={"validate": True},
              worker_kwargs={"validate": True, **worker_kwargs})
    if pkg == "port":
        return LocalCluster(device="cpu", **kw)
    return RefLocalCluster(**kw)


async def _settled(futs):
    """Wait for the futures without fetching their values (a fetch reads
    a spilled key back into the fast layer)."""
    while not all(f.done() for f in futs):
        await asyncio.sleep(0.01)


def _client(pkg, address):
    return (Client if pkg == "port" else RefClient)(address)


async def serves_spilled_data(pkg):
    """``tests/test_spill_memory.py:72``'s scenario: data evicted to disk
    is still gatherable and usable as a dependency."""
    async with _new_cluster(pkg, memory_limit=10**12) as cluster:
        async with _client(pkg, cluster.scheduler_address) as c:
            fut = c.submit(payload, 1000, key="spillme")
            first = (await fut.result())[:7]
            worker = cluster.workers[0]
            while "spillme" in worker.data.fast:
                worker.data.evict()
            on_disk = "spillme" in worker.data.slow
            again = (await fut.result())[:7]
            ln = await c.submit(len, fut).result()
            return first, on_disk, again, ln, worker.data.spilled_count


async def spills_to_its_target(pkg, make):
    """One worker of one thread whose ``memory_limit`` puts the target
    (0.6 x limit) at six 100 kB blocks: the buffer spills as results land,
    a gather reads the spilled blocks back over the target, and the memory
    manager's check (called here, its periodic callback stopped so that
    nothing races it) spills back down to the target."""
    with (port_config if pkg == "port" else ref_config).set(RSS_OFF):
        async with _new_cluster(pkg, memory_limit=1_000_000) as cluster:
            async with _client(pkg, cluster.scheduler_address) as c:
                worker = cluster.workers[0]
                worker.memory_manager.pc.stop()
                futs = [c.submit(make, i, key=f"block-{i}") for i in range(10)]
                await _settled(futs)
                data = worker.data
                after_put = (list(data.fast), list(data.slow), data.fast_bytes,
                             data.spilled_count)
                sums = [float(np.asarray(v).sum()) for v in await c.gather(futs)]
                after_read = (list(data.fast), data.fast_bytes, data.unspilled_count)
                await worker.memory_manager.check()
                after_check = (list(data.fast), list(data.slow), data.fast_bytes,
                               data.spilled_count)
                return after_put, sums, after_read, after_check


async def paused_worker_stops_executing(pkg):
    """``tests/test_spill_memory.py:96``'s scenario."""
    if pkg == "port":
        from distributed_tpu_torch.worker.state_machine import PauseEvent, UnpauseEvent
    else:
        from distributed_tpu.worker.state_machine import PauseEvent, UnpauseEvent
    async with _new_cluster(pkg) as cluster:
        worker = cluster.workers[0]
        async with _client(pkg, cluster.scheduler_address) as c:
            worker.handle_stimulus(PauseEvent(stimulus_id=seq_name("test-pause")))
            worker.batched_stream.send({"op": "worker-status-change", "status": "paused",
                                        "stimulus_id": "test-pause"})
            await asyncio.sleep(0.05)
            running = len(cluster.scheduler.state.running)
            fut = c.submit(eleven, key="paused-task")
            await asyncio.sleep(0.1)
            done = fut.done()
            worker.handle_stimulus(UnpauseEvent(stimulus_id=seq_name("test-unpause")))
            worker.batched_stream.send({"op": "worker-status-change", "status": "running",
                                        "stimulus_id": "test-unpause"})
            return running, done, await asyncio.wait_for(fut.result(), 10)


async def pause_and_unpause_by_rss(pkg, monkeypatch):
    """The manager's check with a stand-in RSS: over ``pause`` the worker
    pauses and leaves the scheduler's running set, under ``0.95 x pause``
    it comes back, and a task queued meanwhile runs."""
    module = memory if pkg == "port" else ref_memory
    rss = {"now": 0}
    monkeypatch.setattr(module, "_process_rss", lambda: rss["now"])
    limit = 10**9
    async with _new_cluster(pkg, memory_limit=limit) as cluster:
        worker, s = cluster.workers[0], cluster.scheduler
        async with _client(pkg, cluster.scheduler_address) as c:
            seen = []
            for frac in (0.5, 0.85, 0.78, 0.7):
                rss["now"] = int(frac * limit)
                await worker.memory_manager.check()
                await asyncio.sleep(0.05)
                seen.append((frac, worker.memory_manager._paused, worker.status.name,
                             len(s.state.running)))
                if frac == 0.85:
                    fut = c.submit(eleven, key="queued-while-paused")
                    await asyncio.sleep(0.1)
                    seen.append(fut.done())
            return seen, await asyncio.wait_for(fut.result(), 10)


@gen_test(timeout=60)
async def test_the_worker_serves_spilled_data_as_the_reference():
    assert await serves_spilled_data("port") == await serves_spilled_data("reference")


@pytest.mark.parametrize("kind", ["numpy", "torch"])
@gen_test(timeout=60)
async def test_the_worker_spills_to_its_target_as_the_reference(kind):
    want = await spills_to_its_target("reference", block)
    got = await spills_to_its_target("port", block if kind == "numpy" else tensor_block)
    assert got == want
    (fast, slow, _, spilled), sums, (read, read_bytes, unspilled), after = got
    assert len(fast) == 6 and len(slow) == 4 and spilled == 4
    assert sums == [12_500.0 * i for i in range(10)]
    assert len(read) == 10 and read_bytes == 1_000_000 and unspilled == 4
    assert after[2] == 600_000 and after[3] == 8


@gen_test(timeout=60)
async def test_a_paused_worker_stops_executing_as_the_reference():
    got = await paused_worker_stops_executing("port")
    assert got == await paused_worker_stops_executing("reference")
    assert got == (0, False, 11)


@gen_test(timeout=60)
async def test_the_pause_threshold_reads_rss_as_the_reference(monkeypatch):
    got = await pause_and_unpause_by_rss("port", monkeypatch)
    assert got == await pause_and_unpause_by_rss("reference", monkeypatch)
    seen, result = got
    assert [x[1] for x in seen if isinstance(x, tuple)] == [False, True, True, False]
    assert result == 11


def test_rss_reads_zero_without_psutil(monkeypatch):
    """Without psutil the RSS reads 0, so the spill and pause thresholds
    never fire: the reference's rule, kept."""
    real = builtins.__import__

    def no_psutil(name, *args, **kwargs):
        if name == "psutil":
            raise ImportError("psutil is absent")
        return real(name, *args, **kwargs)

    assert memory._process_rss() > 0
    monkeypatch.setattr(builtins, "__import__", no_psutil)
    assert memory._process_rss() == 0 == ref_memory._process_rss()


@gen_test(timeout=60)
async def test_an_evicted_tensor_is_freed(tmp_path):
    """Once a key is evicted from a live worker's buffer, nothing else
    holds its tensor (the executor's result, the task state): the tensor
    dies with the eviction, so on the card its device memory is freed.
    One executor thread, so that a no-op through the executor shows it
    has let go of the last task's result."""
    async with LocalCluster(n_workers=1, threads_per_worker=1, device="cpu",
                            scheduler_kwargs={"validate": True},
                            worker_kwargs={"validate": True, "memory_limit": 10**12}) as cluster:
        async with Client(cluster.scheduler_address) as c:
            futs = c.map(tensor_block, range(4))
            await _settled(futs)
            worker = cluster.workers[0]
            # the executor's one thread holds its last result until it
            # takes the next item: let it take one
            await asyncio.get_running_loop().run_in_executor(worker.executor, int)
            refs = {f.key: weakref.ref(worker.data.fast[f.key]) for f in futs}
            gc.collect()
            while worker.data.fast:
                worker.data.evict()
            assert all(r() is None for r in refs.values()), \
                [k for k, r in refs.items() if r() is not None]
            back = await c.gather(c.map(total, futs))
            assert back == [12_500.0 * i for i in range(4)]
            directory = worker.data.spill_directory
            assert os.path.isdir(directory)
    assert not os.path.exists(directory)


def test_the_sampler_keeps_no_frame_between_samples():
    """The shared profiler's sampling thread lets go of the frames it
    sampled once the tick is done.  It held the last tick's
    ``sys._current_frames()`` until its next sample, which an idle worker
    never asks for, and a sampled frame keeps its locals alive after its
    function returns: a task's result (the tensor of
    ``test_an_evicted_tensor_is_freed``) outlived its eviction whenever a
    sample caught the executor thread holding it."""
    from distributed_tpu_torch.diagnostics.profile import Profiler

    class Block:
        pass

    held, release, sampling = threading.Event(), threading.Event(), [True]
    block = Block()
    ref = weakref.ref(block)

    def task(x):
        held.set()
        release.wait(10)

    thread = threading.Thread(target=task, args=(block,))
    del block
    thread.start()
    held.wait(10)
    prof = Profiler(interval=0.001, cycle=1000, idents=lambda: [thread.ident],
                    active=lambda: sampling[0])
    prof.start()
    try:
        deadline = time.monotonic() + 10
        while prof.current["count"] == 0 and time.monotonic() < deadline:
            time.sleep(0.001)
        assert prof.current["count"] > 0
        sampling[0] = False  # idle: the sampler takes no more samples
        time.sleep(0.05)     # ticks without a sample
        release.set()
        thread.join(10)
        assert ref() is None
    finally:
        release.set()
        prof.stop()
