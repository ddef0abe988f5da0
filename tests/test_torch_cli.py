"""The port's command line (``cli/scheduler.py``, ``cli/worker.py``,
``cli/spec.py``, ``cli/ssh.py``) against the reference's, on the CPU.

Each parser has the reference's flags and defaults but for the named
divergences: ``--device`` on the scheduler and the ssh launcher (the
scheduler's device, the card unless ``cpu`` is asked for), and on the
worker torch's rendezvous (``--master-addr``, ``--master-port``,
``--rank``, ``--world-size``, ``--local-rank``, ``--device``) in place of
``--jax-coordinator``, ``--jax-process-id``, ``--jax-num-processes`` and
``--jax-cpu-devices``.  ``python -m distributed_tpu_torch.cli.scheduler
--device cpu`` prints its marker, a worker started the same way joins it
and runs work, and both exit 0 on SIGTERM; ``--version`` prints the
port's version.  The join flags set the rendezvous, are refused with
``--nworkers 2``, and under ``--nanny`` the spawned worker, not its
parent, joins a gloo group of one.  A node's process leaves no sampling
thread alive into the interpreter's finalization.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import operator
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from distributed_tpu.cli import scheduler as ref_cli_scheduler
from distributed_tpu.cli import spec as ref_cli_spec
from distributed_tpu.cli import ssh as ref_cli_ssh
from distributed_tpu.cli import worker as ref_cli_worker
import distributed_tpu_torch
from distributed_tpu_torch.cli import scheduler as cli_scheduler
from distributed_tpu_torch.cli import spec as cli_spec
from distributed_tpu_torch.cli import ssh as cli_ssh
from distributed_tpu_torch.cli import worker as cli_worker
from distributed_tpu_torch.client.client import Client

from conftest import gen_test

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
# a node's start under the suite's load of 6 busy processes
START_S = 120

JOIN_FLAGS = {"--master-addr", "--master-port", "--rank", "--world-size", "--local-rank", "--device"}
JAX_FLAGS = {"--jax-coordinator", "--jax-process-id", "--jax-num-processes", "--jax-cpu-devices"}
DIVERGENCES = {  # module: (flags the port adds, flags it drops)
    "scheduler": ({"--device"}, set()),
    "worker": (JOIN_FLAGS, JAX_FLAGS),
    "spec": (set(), set()),
    "ssh": ({"--device"}, set()),
}
MODULES = {"scheduler": (cli_scheduler, ref_cli_scheduler), "worker": (cli_worker, ref_cli_worker),
           "spec": (cli_spec, ref_cli_spec), "ssh": (cli_ssh, ref_cli_ssh)}


def _options(parser: argparse.ArgumentParser) -> dict:
    """Each flag (or positional) with its default, nargs and action type."""
    return {(a.option_strings[0] if a.option_strings else a.dest):
            (a.dest, a.default, a.nargs, type(a).__name__, a.type)
            for a in parser._actions if not isinstance(a, argparse._HelpAction)}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_each_parser_has_the_references_flags_but_the_divergences(name):
    port, ref = (_options(m.make_parser()) for m in MODULES[name])
    added, dropped = DIVERGENCES[name]
    assert set(port) - set(ref) == added and set(ref) - set(port) == dropped
    for flag in set(port) & set(ref):
        if (name, flag) == ("ssh", "--remote-python"):
            continue  # both default to their own interpreter
        assert port[flag] == ref[flag], flag
    assert port.get("--device", (None, None))[1] is None  # the card unless asked


@pytest.mark.parametrize("name", ["scheduler", "worker", "ssh"])
def test_version_prints_the_ports(name, capsys):
    argv = ["--version"] if name != "worker" else ["tcp://x:1", "--version"]
    assert MODULES[name][0].main(argv) == 0
    assert capsys.readouterr().out.strip() == distributed_tpu_torch.__version__


def _join_args(*extra):
    return cli_worker.make_parser().parse_args(
        ["tcp://127.0.0.1:1", "--master-addr", "10.0.0.1", "--master-port", "29500",
         "--rank", "3", "--world-size", "4", *extra])


def test_the_join_flags_set_the_rendezvous():
    assert cli_worker.join_environment(cli_worker.make_parser().parse_args(["tcp://h:1"])) == {}
    assert cli_worker.join_environment(_join_args()) == {
        "MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "29500", "RANK": "3", "WORLD_SIZE": "4",
        cli_worker.JOIN_DEVICE_ENV: ""}
    assert cli_worker.join_environment(_join_args("--local-rank", "1", "--device", "cpu")) == {
        "MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "29500", "RANK": "3", "WORLD_SIZE": "4",
        "LOCAL_RANK": "1", cli_worker.JOIN_DEVICE_ENV: "cpu"}


@pytest.mark.parametrize("nanny", [False, True])
def test_a_join_needs_one_worker(nanny, monkeypatch):
    for name in ("MASTER_ADDR", "DTPU_WORKER__PRELOAD"):
        monkeypatch.delenv(name, raising=False)
    args = _join_args("--nworkers", "2", *(["--nanny"] if nanny else []))
    with pytest.raises(SystemExit, match="--nworkers 1"):
        asyncio.run(cli_worker.run(args))
    assert "MASTER_ADDR" not in os.environ  # refused before the environment changes
    ref_args = ref_cli_worker.make_parser().parse_args(
        ["tcp://127.0.0.1:1", "--jax-coordinator", "h:1", "--nworkers", "2", "--nanny"])
    with pytest.raises(SystemExit, match="--nworkers 1"):
        asyncio.run(ref_cli_worker.run(ref_args))


# ------------------------------------------------------------ processes


async def _start(*argv, marker):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", *argv, stdout=asyncio.subprocess.PIPE,
        stderr=asyncio.subprocess.STDOUT, env=env, cwd=ROOT)
    seen = []

    async def scan():
        while True:
            raw = await proc.stdout.readline()
            if not raw:
                raise RuntimeError(f"{argv[0]} exited before {marker!r}:\n" + "".join(seen[-40:]))
            line = raw.decode(errors="replace")
            seen.append(line)
            if line.startswith(marker):
                return line.split()[-1]

    try:
        return proc, await asyncio.wait_for(scan(), START_S)
    except BaseException:
        proc.kill()
        await proc.wait()
        raise


async def _stop(proc) -> tuple[int, str]:
    proc.send_signal(signal.SIGTERM)
    try:
        out = await asyncio.wait_for(proc.stdout.read(), 60)
        return await asyncio.wait_for(proc.wait(), 60), out.decode(errors="replace")
    except asyncio.TimeoutError:
        proc.kill()
        await proc.wait()
        raise


async def _worker_info(client, name):
    info = await client.scheduler_info()
    host, port = info["dashboard"].removeprefix("http://").rsplit(":", 1)
    reader, writer = await asyncio.open_connection(host, int(port))
    writer.write(f"GET /workers/{name}/info HTTP/1.0\r\n\r\n".encode())
    await writer.drain()
    data = await reader.read()
    writer.close()
    return json.loads(data.partition(b"\r\n\r\n")[2])


@gen_test(timeout=300)
async def test_a_cli_scheduler_and_worker_run_work_and_stop_on_sigterm():
    sched, addr = await _start("distributed_tpu_torch.cli.scheduler", "--device", "cpu",
                               "--port", "0", marker="Scheduler at:")
    try:
        assert addr.startswith("tcp://127.0.0.1:")
        worker, waddr = await _start("distributed_tpu_torch.cli.worker", addr, "--name", "w0",
                                     "--nthreads", "2", marker="Worker at:")
        try:
            async with Client(addr) as c:
                await c.wait_for_workers(1, timeout=START_S)
                assert await c.gather(c.map(operator.neg, range(6))) == [0, -1, -2, -3, -4, -5]
                info = await _worker_info(c, "w0")
                assert info["address"] == waddr and info["nthreads"] == 2
                assert info["extra"].get("jax_devices") is None  # no join asked
        finally:
            rc, out = await _stop(worker)
            assert rc == 0, out[-3000:]
    finally:
        rc, out = await _stop(sched)
        assert rc == 0, out[-3000:]


@gen_test(timeout=300)
async def test_under_nanny_the_spawned_worker_joins_and_not_its_parent():
    """A group of one over gloo: a second join at that rank (the parent's)
    would fail at the rendezvous, and the worker would not register."""
    from test_torch_worker_join import _free_port

    sched, addr = await _start("distributed_tpu_torch.cli.scheduler", "--device", "cpu",
                               "--port", "0", "--protocol", "ws", marker="Scheduler at:")
    try:
        assert addr.startswith("ws://127.0.0.1:")
        worker, waddr = await _start(
            "distributed_tpu_torch.cli.worker", addr, "--name", "n0", "--nanny",
            "--master-addr", "localhost", "--master-port", str(_free_port()), "--rank", "0",
            "--world-size", "1", "--device", "cpu", marker="Worker at:")
        try:
            assert waddr.startswith("ws://")
            async with Client(addr) as c:
                await c.wait_for_workers(1, timeout=START_S)
                assert await c.submit(operator.add, 2, 3).result() == 5
                info = await _worker_info(c, "n0")
                assert info["extra"]["jax_devices"] == [0]
        finally:
            rc, out = await _stop(worker)
            assert rc == 0, out[-3000:]
    finally:
        rc, out = await _stop(sched)
        assert rc == 0, out[-3000:]


_EXIT_PROBE = """
import atexit, json, threading
# registered first, so it runs after the profile module's own exit hook
atexit.register(lambda: print(json.dumps(sorted(t.name for t in threading.enumerate()))))
from distributed_tpu_torch.diagnostics.profile import Profiler
p = Profiler(idents=lambda: [threading.main_thread().ident], interval=0.001)
p.start()
p.stop()
"""


def test_no_sampling_thread_outlives_the_program():
    """The profiler's shared thread lingers 0.5 s after its last profiler
    stops; left alive into finalization it could abort a process that had
    done its work (exit code 134).  Stopped at exit, it is gone before."""
    out = subprocess.run([sys.executable, "-c", _EXIT_PROBE], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)), cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == ["MainThread"]
