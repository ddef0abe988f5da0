"""``dtpu-ssh``: bring up a cluster over ssh (reference cli/dask_ssh.py).

    python -m distributed_tpu_torch.cli.ssh gateway node1 node2 \
        --nthreads 2 --nanny

The first host runs the scheduler, the rest run one worker each.  Runs
until interrupted; Ctrl-C tears the whole cluster down.

The port's copy of ``distributed_tpu/cli/ssh.py``, line for line but for
``--device``, the remote scheduler's device (``cli/scheduler.py``).
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import shlex
import signal
import sys


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dtpu-ssh", description="distributed_tpu_torch ssh cluster"
    )
    p.add_argument("hosts", nargs="*",
                   help="hosts: first runs the scheduler, rest run workers")
    p.add_argument("--nthreads", type=int, default=1, help="threads per worker")
    p.add_argument("--nanny", action="store_true", default=False,
                   help="run each worker under a nanny (auto-restart)")
    p.add_argument("--memory-limit", default="0",
                   help="per-worker memory limit ('auto', '4GiB', 0.5, 0=off)")
    p.add_argument("--remote-python", default=sys.executable,
                   help="python executable on the remote hosts")
    p.add_argument("--ssh-command", default="ssh",
                   help="connect command (shell-split), e.g. "
                        "'ssh -o StrictHostKeyChecking=no'")
    p.add_argument("--scheduler-port", type=int, default=8786,
                   help="scheduler port on the first host (0=random)")
    p.add_argument("--device", default=None,
                   help="the scheduler's device (default: the CUDA device of "
                        "the first host; 'cpu' runs the plain versions)")
    p.add_argument("--log-level", default="INFO")
    p.add_argument("--version", action="store_true")
    return p


async def run(args: argparse.Namespace) -> int:
    from distributed_tpu_torch.deploy.ssh import SSHCluster

    cluster = SSHCluster(
        args.hosts,
        connect_command=shlex.split(args.ssh_command),
        remote_python=args.remote_python,
        nthreads=args.nthreads,
        nanny=args.nanny,
        memory_limit=args.memory_limit,
        scheduler_options={"port": args.scheduler_port},
        device=args.device,
    )
    async with cluster:
        print(f"Scheduler at: {cluster.scheduler_address}", flush=True)
        for name, w in sorted(cluster.workers.items()):
            print(f"Worker {name} at: {w.worker_address}", flush=True)
        loop = asyncio.get_running_loop()
        stop = asyncio.Event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
    return 0


def main(argv: list[str] | None = None) -> int:
    args = make_parser().parse_args(argv)
    if args.version:
        from distributed_tpu_torch import __version__

        print(__version__)
        return 0
    if len(args.hosts) < 2:
        make_parser().error("need >= 2 hosts: scheduler host + worker hosts")
    logging.basicConfig(
        level=args.log_level.upper(),
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )
    return asyncio.run(run(args))


if __name__ == "__main__":
    sys.exit(main())
