"""The port's nanny and its process handle (``worker/nanny.py``,
``worker/process.py``) against the reference's, on the CPU: a worker in a
spawned process.

A ``Nanny`` spawns its worker with the ``spawn`` start method (a forked
child of a parent that has touched CUDA cannot use the card), the worker
computes there, and the child has imported nothing of the JAX package or
of JAX (asked through ``run``).  Killed with SIGKILL, the worker comes
back under a new address and the scheduler recomputes the keys it held,
to the same results; a graceful kill starts no new worker.  Each of these
two scenarios runs once on the reference's ``Scheduler``, ``Nanny`` and
``Client`` and once on the port's, and the outcomes must be equal: the
results, which keys were lost and recomputed, a new pid, the worker
count, the nanny's status and exit code, whether a new process started.
Work stealing is off in both, so each key stays on the worker it was
pinned to until that worker dies.

This module imports nothing of the JAX package and not ``conftest`` at
its top: the port's spawned worker imports it by name to run the task
functions defined here, and must not import the JAX package with it.
The reference's classes are imported inside :func:`_api`.  Each scenario
bounds itself with ``asyncio.wait_for``.
"""

from __future__ import annotations

import asyncio
import multiprocessing
import os
import signal
import sys
import time

import numpy as np
import torch

from distributed_tpu_torch import config
from distributed_tpu_torch.client.client import Client
from distributed_tpu_torch.scheduler.server import Scheduler
from distributed_tpu_torch.worker import nanny as nanny_module
from distributed_tpu_torch.worker import process
from distributed_tpu_torch.worker.nanny import Nanny

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)

TIMEOUT_S = 60
# the reference's child imports JAX: keep it on the CPU
CHILD_ENV = {"JAX_PLATFORMS": "cpu"}


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, TIMEOUT_S))


def seeded_block(seed, n=256):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.integers(0, 8, (n, 4)).astype(np.float32))


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "distributed_tpu",
                                                                "msgpack", "cloudpickle", "yaml"))


def child_pid():
    return os.getpid()


def _api(pkg):
    """``(config, Scheduler, Nanny, Client, the scheduler's keywords)`` of
    the port or of the reference."""
    if pkg == "port":
        return config, Scheduler, Nanny, Client, {"device": "cpu"}
    from distributed_tpu import config as ref_config
    from distributed_tpu.client.client import Client as RefClient
    from distributed_tpu.scheduler.server import Scheduler as RefScheduler
    from distributed_tpu.worker.nanny import Nanny as RefNanny

    return ref_config, RefScheduler, RefNanny, RefClient, {}


async def _until(cond, seconds=TIMEOUT_S):
    deadline = time.monotonic() + seconds
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        await asyncio.sleep(0.05)


def _bytes(results):
    return [r.numpy().tobytes() for r in results]


async def kill_and_restart(pkg):
    """Two nannies; eight blocks pinned to their workers in turn; one
    worker SIGKILLed.  Returns the results before and after, the indices of
    the keys the dead worker held, the indices of the keys whose holder
    changed, whether the nanny's process is new, the worker count and the
    nanny's status."""
    cfg, Sched, Nan, Cli, kw = _api(pkg)
    with cfg.set({"scheduler.work-stealing": False}):
        async with Sched(listen_addr="tcp://127.0.0.1:0", **kw) as s:
            a, b = nannies = [Nan(s.address, nthreads=1, env=CHILD_ENV) for _ in range(2)]
            try:
                # the two spawns side by side
                await asyncio.gather(a.start(), b.start())
                async with Cli(s.address) as c:
                    futs = [c.submit(seeded_block, i, workers=[w], allow_other_workers=True)
                            for i, w in enumerate([a.worker_address, b.worker_address] * 4)]
                    before = await c.gather(futs)
                    held = await c.who_has(futs)
                    old, old_pid = a.worker_address, a.process.pid
                    on_a = [i for i, f in enumerate(futs) if old in held[f.key]]
                    os.kill(old_pid, signal.SIGKILL)
                    await _until(lambda: a.worker_address != old
                                 and a.worker_address in s.state.workers)
                    await _until(lambda: old not in s.state.workers)
                    after = await c.gather(futs)
                    now = await c.who_has(futs)
                    moved = [i for i, f in enumerate(futs)
                             if sorted(now[f.key]) != sorted(held[f.key])]
                    return (_bytes(before), _bytes(after), on_a, moved,
                            a.process.pid != old_pid, len(s.state.workers), a.status.name)
            finally:
                for n in nannies:
                    await n.close()


async def graceful_kill(pkg):
    """One nanny, its worker killed through ``Nanny.kill``.  Returns the
    exit code, whether the nanny kept the same process, whether it lives,
    the nanny's status and the scheduler's worker count once it has
    dropped the worker."""
    cfg, Sched, Nan, Cli, kw = _api(pkg)
    async with Sched(listen_addr="tcp://127.0.0.1:0", **kw) as s:
        async with Nan(s.address, nthreads=1, env=CHILD_ENV) as n:
            proc = n.process
            await n.kill()
            exitcode = proc.exitcode
            await asyncio.sleep(1.0)  # past the restart backoff of 0.5 s
            await _until(lambda: not s.state.workers)
            return exitcode, n.process is proc, proc.is_alive(), n.status.name, \
                len(s.state.workers)


def test_processes_are_spawned():
    from distributed_tpu.worker import process as ref_process

    assert process._ctx.get_start_method() == ref_process._ctx.get_start_method() == "spawn"

    async def main():
        async with Scheduler(listen_addr="tcp://127.0.0.1:0", device="cpu") as s:
            async with Nanny(s.address, nthreads=1) as n:
                assert type(n.process._process) is multiprocessing.get_context("spawn").Process
                assert n.process.pid != os.getpid() and n.process.is_alive()
                assert n.worker_address in s.state.workers
                async with Client(s.address) as c:
                    futs = c.map(seeded_block, range(6))
                    got = await c.gather(futs)
                    mods = await c.run(forbidden_modules)
                    pids = await c.run(child_pid)
                return got, mods, pids, n.process.pid

    got, mods, pids, pid = run(main())
    assert all(torch.equal(g, seeded_block(i)) for i, g in enumerate(got))
    assert list(mods.values()) == [[]], mods
    assert list(pids.values()) == [pid]
    # the child's entry point is the port's own
    assert nanny_module._run_worker_process.__module__ == "distributed_tpu_torch.worker.nanny"


def test_a_killed_worker_comes_back_and_its_keys_are_recomputed():
    port = run(kill_and_restart("port"))
    ref = run(kill_and_restart("ref"))
    assert port == ref
    before, after, on_a, moved, new_pid, n_workers, status = port
    assert on_a == moved == [0, 2, 4, 6]
    assert new_pid and n_workers == 2 and status == "running"
    assert before == after == _bytes(seeded_block(i) for i in range(8))


def test_a_graceful_kill_does_not_restart():
    port = run(graceful_kill("port"))
    assert port == run(graceful_kill("ref"))
    exitcode, same, alive, status, n_workers = port
    assert exitcode is not None and same and not alive and status == "running" and n_workers == 0
