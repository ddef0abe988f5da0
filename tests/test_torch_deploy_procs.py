"""The port's process-backed clusters (``deploy/subprocess.py``,
``deploy/ssh.py``) against the reference's, on the CPU (the reference's
twin is ``tests/test_deploy_procs.py``).

``SubprocessCluster`` starts its nodes through the port's command line
(``python -m distributed_tpu_torch.cli.*``, never ``distributed_tpu.cli``);
a roundtrip, then ``scale`` up to two workers and back to one, gives the
reference's ``SubprocessCluster``'s results on the same work.  Its device
reaches the scheduler as ``--device``.  ``SSHCluster``'s commands are the
reference's but for the module names and ``--device``, and it needs two
hosts.  The fake-ssh roundtrip is marked ``slow``, as the reference's is.

Task functions come from the standard library: the port has no
cloudpickle, and a spawned node imports no test module.
"""

from __future__ import annotations

import asyncio
import operator
import stat
import sys
import tempfile
from pathlib import Path

import pytest
import torch

from distributed_tpu.client.client import Client as RefClient
from distributed_tpu.deploy import ssh as ref_ssh
from distributed_tpu.deploy import subprocess as ref_subprocess
from distributed_tpu_torch.client.client import Client
from distributed_tpu_torch.deploy import SSHCluster, SubprocessCluster
from distributed_tpu_torch.deploy import ssh, subprocess as port_subprocess

from conftest import gen_test

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)


def _port_argv(argv: list[str]) -> list[str]:
    """The reference's command with the port's module names."""
    return [a.replace("distributed_tpu.cli.", "distributed_tpu_torch.cli.") for a in argv]


async def _scenario(cluster, client_cls) -> tuple:
    """A roundtrip on one worker, ``scale(2)``, work on both, ``scale(1)``,
    work on the survivor: the results and the worker counts."""
    out = []
    async with cluster:
        out.append(cluster.scheduler_address.split(":")[:2])
        async with client_cls(cluster.scheduler_address) as c:
            out.append(await c.gather(c.map(operator.neg, range(8))))
            await cluster.scale(2)
            out.append(len(cluster.workers))
            await c.wait_for_workers(2, timeout=120)
            out.append(await c.gather(c.map(operator.neg, range(100, 112))))
            await cluster.scale(1)
            out.append(len(cluster.workers))
            out.append(await c.submit(operator.add, 100, 1).result())
        argv = cluster.scheduler._argv()
    return tuple(out), argv


@gen_test(timeout=300)
async def test_roundtrip_and_scale_equal_the_references():
    (ref, ref_argv), (ours, argv) = await asyncio.gather(
        _scenario(ref_subprocess.SubprocessCluster(n_workers=1, nthreads=1), RefClient),
        _scenario(SubprocessCluster(n_workers=1, nthreads=1, device="cpu"), Client))
    assert ours == ref
    assert ours[0] == ["tcp", "//127.0.0.1"] and ours[2] == 2 and ours[4] == 1
    assert argv[:3] == [sys.executable, "-m", "distributed_tpu_torch.cli.scheduler"]
    assert argv == _port_argv(ref_argv) + ["--device", "cpu"]


def test_the_commands_are_the_references_but_the_module_names():
    sched = port_subprocess.SubprocessScheduler(port=8786, protocol="ws")
    ref_sched = ref_subprocess.SubprocessScheduler(port=8786, protocol="ws")
    assert sched._argv() == _port_argv(ref_sched._argv())
    assert port_subprocess.SubprocessScheduler(device="cpu")._argv() == \
        _port_argv(ref_subprocess.SubprocessScheduler()._argv()) + ["--device", "cpu"]
    kw = dict(name="w", nthreads=2, nanny=True, memory_limit="1GiB", extra_args=["--x"])
    assert port_subprocess.SubprocessWorker("tcp://h:1", **kw)._argv() == \
        _port_argv(ref_subprocess.SubprocessWorker("tcp://h:1", **kw)._argv())
    assert port_subprocess.child_env({"A": "1"}) == ref_subprocess.child_env({"A": "1"})


def test_ssh_commands_are_the_references_but_the_module_names():
    kw = dict(port=8786, connect_command=["ssh", "-A"], remote_python="/srv/py/bin/python",
              env_vars={"X": "a b"})
    s, ref_s = ssh.SSHScheduler("gw", **kw), ref_ssh.SSHScheduler("gw", **kw)
    assert s._argv()[:3] == ref_s._argv()[:3] == ["ssh", "-A", "gw"]
    assert s._argv()[3] == ref_s._argv()[3].replace("distributed_tpu.cli.", "distributed_tpu_torch.cli.")
    assert "/srv/py/bin/python -m distributed_tpu_torch.cli.scheduler" in s._argv()[3]
    assert ssh.SSHScheduler("gw", device="cpu", **kw)._argv()[3] == s._argv()[3] + " --device cpu"
    for wkw in ({"nthreads": 2, "nanny": True}, {"bind_host": "10.0.0.7", "name": "n"}):
        w = ssh.SSHWorker("tcp://gw:8786", host="node1", **wkw)
        ref_w = ref_ssh.SSHWorker("tcp://gw:8786", host="node1", **wkw)
        assert w._argv()[:2] == ["ssh", "node1"]
        assert w._argv()[2] == ref_w._argv()[2].replace(
            "distributed_tpu.cli.", "distributed_tpu_torch.cli.")
    cluster = SSHCluster(["gw", "n1", "n2"], device="cpu")
    assert cluster.scheduler_spec["cls"] is ssh.SSHScheduler
    assert cluster.scheduler_spec["options"]["device"] == "cpu"
    assert sorted(cluster.worker_spec) == sorted(ref_ssh.SSHCluster(["gw", "n1", "n2"]).worker_spec)


def test_ssh_cluster_needs_two_hosts():
    with pytest.raises(ValueError, match="hosts"):
        SSHCluster(["onlyhost"])
    with pytest.raises(ValueError, match="hosts"):
        ref_ssh.SSHCluster(["onlyhost"])


def _write_fake_ssh(tmp_path: Path) -> str:
    """An 'ssh client' that ignores the host and runs the command locally."""
    script = tmp_path / "fake-ssh"
    script.write_text('#!/bin/bash\nshift\nexec bash -c "$*"\n')
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script)


@pytest.mark.slow
@gen_test(timeout=180)
async def test_ssh_cluster_roundtrip():
    with tempfile.TemporaryDirectory() as td:
        fake_ssh = _write_fake_ssh(Path(td))
        env = port_subprocess.child_env()
        async with SSHCluster(
            ["127.0.0.1", "127.0.0.1", "127.0.0.1"],
            connect_command=[fake_ssh],
            remote_python=sys.executable,
            env_vars={"PYTHONPATH": env["PYTHONPATH"]},
            scheduler_options={"port": 0},
            device="cpu",
        ) as cluster:
            assert cluster.scheduler_address.startswith("tcp://127.0.0.1:")
            assert len(cluster.workers) == 2
            async with Client(cluster.scheduler_address) as c:
                assert await c.gather(c.map(operator.neg, range(6))) == [0, -1, -2, -3, -4, -5]
