"""A worker's process-group join (``worker/join.py``) and its setup from a
config preload (``worker/setup.py``), live on the reference's
``Scheduler`` and ``Worker`` over gloo.

The preload is the README's source, word for word, with ``DEVICE = None``
turned into ``DEVICE = "cpu"`` (the tests run without a card).  What is checked is
what the scheduler records: the worker registers ``jax_devices == [0]``
when ``MASTER_ADDR`` is set, nothing without it, and ``None`` when the
same source runs as the CLI's ``--preload`` runs it, after the worker has
registered (the reason a deployment uses ``worker.preload``).  Every test
leaves no process group and no install behind; the fixture asserts it.
"""

from __future__ import annotations

import importlib
import os
import random
import re
import socket
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from distributed_tpu import config as dtpu_config
from distributed_tpu.diagnostics import device_profile as ref_profile
from distributed_tpu.preloading import process_preloads
from distributed_tpu.scheduler.server import Scheduler
from distributed_tpu.worker.server import Worker
from distributed_tpu_torch._install import install_count
from distributed_tpu_torch.diagnostics import device_profile
from distributed_tpu_torch.protocol.serialize import torch_dumps
from distributed_tpu_torch.utils.sizeof import tensor_sizeof
from distributed_tpu_torch.worker.join import GROUP, join_process_group

from conftest import gen_test

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SIZEOF_MOD = importlib.import_module("distributed_tpu.utils.sizeof")
ref_ser = importlib.import_module("distributed_tpu.protocol.serialize")
RENDEZVOUS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")


def readme_preload() -> str:
    """The README's preload source, with the device set to the CPU."""
    blocks = re.findall(r"```python\n(.*?)```", (ROOT / "README.md").read_text(), re.S)
    (source,) = [b for b in blocks if "async def dtpu_setup" in b and "setup_worker" in b]
    assert source.count("DEVICE = None") == 1
    return source.replace("DEVICE = None", 'DEVICE = "cpu"')


def _free_port() -> int:
    """A free port below the kernel's ephemeral range, for the gloo store's
    bind.  A port the kernel hands out for ``bind(0)`` was free only at the
    pick: under the suite's parallel run another process's ``bind(0)`` (a
    listener, an outgoing connection) could take it before the store bound
    it, and the join failed.  Below the ephemeral range the kernel hands
    out nothing; the candidates are drawn from this process's own seeded
    stream, so two xdist workers rarely try the same port, and a port in
    use is skipped."""
    low, _ = map(int, Path("/proc/sys/net/ipv4/ip_local_port_range").read_text().split())
    rng = random.Random(os.getpid())
    for _ in range(1000):
        port = rng.randrange(max(1024, low - 8192), low)
        with socket.socket() as s:
            try:
                s.bind(("localhost", port))
            except OSError:
                continue
            return port
    raise RuntimeError("no free port below the ephemeral range")


def _nothing_installed() -> bool:
    return all(install_count(kind, target) == 0 for kind, target in (
        ("sizeof", SIZEOF_MOD.sizeof), ("serialization", ref_ser.families),
        ("device_profile", ref_profile), (GROUP, dist)))


@pytest.fixture
def rendezvous(monkeypatch):
    """A world of one in torch's environment; no group or install left after."""
    for name in RENDEZVOUS:
        monkeypatch.delenv(name, raising=False)
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()), "RANK": "0",
           "WORLD_SIZE": "1"}
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert not dist.is_initialized()
    yield env
    if dist.is_initialized():
        dist.destroy_process_group()
        pytest.fail("a process group was left behind")
    assert _nothing_installed()
    assert ref_ser.families["torch"][0] is ref_ser._torch_dumps
    assert ref_profile.active is not device_profile.active


@gen_test(timeout=60)
async def test_config_preload_registers_the_ranks_devices(rendezvous):
    with dtpu_config.set({"worker.preload": [readme_preload()]}):
        async with Scheduler(listen_addr="inproc://") as s:
            async with Worker(s.address, nthreads=1) as w:
                ws = s.state.workers[w.address]
                assert ws.extra["jax_devices"] == [0]
                assert dist.is_initialized() and dist.get_backend() == "gloo"
                assert (dist.get_rank(), dist.get_world_size()) == (0, 1)
                # the installs are live while the worker runs
                assert ref_ser.families["torch"][0] is torch_dumps
                assert SIZEOF_MOD._sizeof_dispatch.registry[torch.Tensor] is tensor_sizeof
                assert ref_profile.active is device_profile.active
                await w.close()
                # its teardown destroyed the group its join created
                assert not dist.is_initialized()


@gen_test(timeout=60)
async def test_the_group_outlives_a_worker_that_closes_first(rendezvous):
    """Two workers of one process share the group and the installs: the
    first to close gives back its counts only; the last destroys the group."""
    with dtpu_config.set({"worker.preload": [readme_preload()]}):
        async with Scheduler(listen_addr="inproc://") as s:
            async with Worker(s.address, nthreads=1) as a, Worker(s.address, nthreads=1) as b:
                assert [s.state.workers[w.address].extra["jax_devices"] for w in (a, b)] == [[0], [0]]
                assert install_count(GROUP, dist) == 2
                await a.close()
                assert dist.is_initialized() and install_count(GROUP, dist) == 1
                assert ref_ser.families["torch"][0] is torch_dumps
                one = torch.ones(1)
                dist.all_reduce(one)  # the group still works for the worker left
                assert one.item() == 1.0
                await b.close()
                assert not dist.is_initialized() and _nothing_installed()


@gen_test(timeout=60)
async def test_without_master_addr_nothing_joins(rendezvous, monkeypatch):
    monkeypatch.delenv("MASTER_ADDR")
    with dtpu_config.set({"worker.preload": [readme_preload()]}):
        async with Scheduler(listen_addr="inproc://") as s:
            async with Worker(s.address, nthreads=1) as w:
                assert "jax_devices" not in s.state.workers[w.address].extra
                assert w.jax_device_indices is None and not dist.is_initialized()
                assert ref_ser.families["torch"][0] is torch_dumps  # the installs still run


@gen_test(timeout=60)
async def test_the_late_cli_style_preload_registers_none(rendezvous):
    """The CLI runs ``--preload`` after ``server.start()``
    (``cli/worker.py:212-216``), so after registration: the same source
    joins the group, but the scheduler already holds ``jax_devices: None``."""
    async with Scheduler(listen_addr="inproc://") as s:
        async with Worker(s.address, nthreads=1) as w:
            (preload,) = process_preloads(w, [readme_preload()])
            await preload.start()
            try:
                assert w.jax_device_indices == [0] and dist.is_initialized()
                assert "jax_devices" not in s.state.workers[w.address].extra
            finally:
                await preload.teardown()
            assert not dist.is_initialized()


def _stand_in():
    import asyncio

    return types.SimpleNamespace(loop=asyncio.get_running_loop(), jax_device_indices=None)


@gen_test(timeout=60)
async def test_a_second_join_reuses_the_group_and_a_mismatch_raises(rendezvous, monkeypatch):
    first, second = _stand_in(), _stand_in()
    try:
        assert await join_process_group(first, device="cpu") is True
        assert await join_process_group(second, device="cpu") is False  # created nothing
        assert first.jax_device_indices == second.jax_device_indices == [0]
        monkeypatch.setenv("WORLD_SIZE", "2")
        with pytest.raises(RuntimeError, match="already exists"):
            await join_process_group(_stand_in(), device="cpu")
    finally:
        dist.destroy_process_group()


@gen_test(timeout=60)
async def test_a_group_made_outside_the_port_is_left_to_its_maker(rendezvous):
    from distributed_tpu_torch.worker.join import hold_process_group

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{rendezvous['MASTER_PORT']}",
                            rank=0, world_size=1)
    try:
        worker = _stand_in()
        assert await hold_process_group(worker, device="cpu") is None
        assert worker.jax_device_indices == [0] and install_count(GROUP, dist) == 0
    finally:
        dist.destroy_process_group()


@gen_test(timeout=60)
async def test_join_needs_the_whole_rendezvous(rendezvous, monkeypatch):
    monkeypatch.delenv("RANK")
    with pytest.raises(RuntimeError, match="RANK is not"):
        await join_process_group(_stand_in(), device="cpu")
    assert not dist.is_initialized()


@gen_test(timeout=60)
async def test_join_on_the_card_needs_cuda(rendezvous, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        await join_process_group(_stand_in())
    assert not dist.is_initialized()


_RANK = r"""
import asyncio, sys, types
sys.path.insert(0, {root!r})
import torch
import torch.distributed as dist
from distributed_tpu_torch.worker.join import GROUP, join_process_group
torch.set_num_threads(1)
worker = types.SimpleNamespace(jax_device_indices=None)
try:
    created = asyncio.run(join_process_group(worker, device="cpu"))
    print("JOINED", created, worker.jax_device_indices, dist.get_world_size(), flush=True)
finally:
    if dist.is_initialized():
        dist.destroy_process_group()
"""


def test_two_gloo_ranks_own_one_index_each():
    port = str(_free_port())
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items() if k not in RENDEZVOUS}
        env.update(MASTER_ADDR="localhost", MASTER_PORT=port, RANK=str(rank), WORLD_SIZE="2",
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, "-c", _RANK.format(root=str(ROOT))],
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                      env=env))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
            outs.append([ln for ln in out.splitlines() if ln.startswith("JOINED")])
    finally:
        for p in procs:
            p.kill()
    assert outs == [["JOINED True [0] 2"], ["JOINED True [1] 2"]]


@gen_test(timeout=60)
async def test_a_setup_that_fails_leaves_nothing_installed(rendezvous, monkeypatch):
    """An install that raises (the device trace's, here) takes out the
    installs made before it and the group the join created."""
    from distributed_tpu_torch.worker import setup

    def refuse(module, device=None):
        raise RuntimeError("refused")

    monkeypatch.setattr(setup, "install_device_profile", refuse)
    with pytest.raises(RuntimeError, match="refused"):
        await setup.setup_worker(
            _stand_in(), sizeof=SIZEOF_MOD.sizeof,
            register_serialization_family=ref_ser.register_serialization_family,
            families=ref_ser.families, device_profile=ref_profile, device="cpu")
    assert not dist.is_initialized() and _nothing_installed()
