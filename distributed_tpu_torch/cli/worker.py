"""``dtpu-worker``: run worker process(es) (reference cli/dask_worker.py).

    python -m distributed_tpu_torch.cli.worker tcp://127.0.0.1:8786 \
        --nworkers 2 --nthreads 1 --nanny

The port's copy of ``distributed_tpu/cli/worker.py``, line for line but
for the device plane's join.  The reference's ``--jax-coordinator``,
``--jax-process-id`` and ``--jax-num-processes`` become torch's rendezvous
(``--master-addr``, ``--master-port``, ``--rank``, ``--world-size``,
``--local-rank``: ``MASTER_ADDR`` ... ``LOCAL_RANK``, what ``torchrun``
sets) and ``--device``, the join's device (the card by default, NCCL;
``cpu`` joins over gloo).  The worker joins from a config preload, this
module's :func:`dtpu_setup` (``worker/join.py``), before it registers, as
the reference's worker joins in its start.  The reference's two rules
hold: the parent does not join under ``--nanny`` (the spawned worker does,
from the environment it inherits), and a join needs ``--nworkers 1``.
``--jax-cpu-devices`` (virtual CPU devices of a jax process) has no
counterpart: a process's mesh devices are ``device_store().devices``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import signal
import sys

#: torch's rendezvous, each set from its flag (``worker/join.py``)
RENDEZVOUS_FLAGS = {"MASTER_ADDR": "master_addr", "MASTER_PORT": "master_port",
                    "RANK": "rank", "WORLD_SIZE": "world_size", "LOCAL_RANK": "local_rank"}
#: the join's device in the worker's process ("" or absent: the CUDA device)
JOIN_DEVICE_ENV = "DISTRIBUTED_TPU_TORCH_JOIN_DEVICE"
#: the config preload that joins: this module's dtpu_setup / dtpu_teardown
JOIN_PRELOAD = "distributed_tpu_torch.cli.worker"


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dtpu-worker", description="distributed_tpu_torch worker"
    )
    p.add_argument("scheduler", help="scheduler address (tcp://host:port)")
    p.add_argument("--nthreads", type=int, default=1, help="threads per worker")
    p.add_argument("--host", default=None,
                   help="interface to bind (default: loopback); a name/IP "
                        "reachable from other hosts, or 'auto' to bind the "
                        "interface this host uses to reach the scheduler")
    p.add_argument("--nworkers", default="1",
                   help="number of worker processes ('auto' = cpu count)")
    p.add_argument("--name", default=None, help="worker name prefix")
    p.add_argument("--memory-limit", default="0",
                   help="memory per worker before spilling: bytes ('4GiB'), "
                        "fraction of host memory (0.5), or 'auto' "
                        "(host/cgroup limit split across --nworkers)")
    p.add_argument("--resources", default=None,
                   help='JSON dict of abstract resources, e.g. \'{"GPU": 2}\'')
    p.add_argument("--nanny", action="store_true", default=False,
                   help="run each worker under a nanny (auto-restart)")
    p.add_argument("--no-nanny", dest="nanny", action="store_false")
    p.add_argument("--preload", action="append", default=[],
                   help="module to import (dtpu_setup hook) at startup")
    p.add_argument("--lifetime", default=None,
                   help="retire the worker gracefully after this long "
                        "(e.g. '1 hour'); for bounded-preemption hosts")
    p.add_argument("--lifetime-stagger", default=None,
                   help="uniform +/- jitter on --lifetime so a fleet "
                        "doesn't cycle in lock-step (default: config)")
    p.add_argument("--lifetime-restart", action="store_true", default=None,
                   help="with --nanny: start a fresh worker after each "
                        "lifetime instead of shutting down (default: config)")
    p.add_argument("--no-lifetime-restart", dest="lifetime_restart",
                   action="store_false",
                   help="override a config-enabled lifetime restart")
    p.add_argument("--tls-ca-file", default=None,
                   help="CA certificate for TLS (tls:// scheduler address)")
    p.add_argument("--tls-cert", default=None, help="worker TLS certificate")
    p.add_argument("--tls-key", default=None, help="worker TLS private key")
    p.add_argument("--master-addr", default=None,
                   help="host of torch.distributed's rendezvous — joins this "
                        "worker to the process group of the device data plane")
    p.add_argument("--master-port", type=int, default=None,
                   help="port of the rendezvous (with --master-addr)")
    p.add_argument("--rank", type=int, default=None,
                   help="this process's rank in the group (0..n-1)")
    p.add_argument("--world-size", type=int, default=None,
                   help="processes in the group")
    p.add_argument("--local-rank", type=int, default=None,
                   help="the card of this process (LOCAL_RANK, needed on CUDA "
                        "unless the environment sets it)")
    p.add_argument("--device", default=None,
                   help="device of the join: the CUDA device by default "
                        "(NCCL), 'cpu' joins over gloo")
    p.add_argument("--log-level", default="INFO")
    p.add_argument("--version", action="store_true")
    return p


def join_environment(args: argparse.Namespace) -> dict[str, str]:
    """The environment the join flags give a worker's process: the
    rendezvous variables that were passed and :data:`JOIN_DEVICE_ENV`;
    ``{}`` without ``--master-addr``."""
    if args.master_addr is None:
        return {}
    env = {
        name: str(getattr(args, flag))
        for name, flag in RENDEZVOUS_FLAGS.items()
        if getattr(args, flag) is not None
    }
    env[JOIN_DEVICE_ENV] = args.device or ""
    return env


_holds: dict = {}


async def dtpu_setup(worker) -> None:
    """Join the process group from the environment (``worker/join.py``),
    held until :func:`dtpu_teardown`."""
    from distributed_tpu_torch.worker.join import hold_process_group

    _holds[worker] = await hold_process_group(
        worker, device=os.environ.get(JOIN_DEVICE_ENV) or None
    )


def dtpu_teardown(worker) -> None:
    held = _holds.pop(worker, None)
    if held is not None:
        held.uninstall()


async def run(args: argparse.Namespace) -> int:
    from distributed_tpu_torch.preloading import process_preloads
    from distributed_tpu_torch.utils.system import parse_memory_limit
    from distributed_tpu_torch.worker.nanny import Nanny
    from distributed_tpu_torch.worker.server import Worker

    nworkers = (
        os.cpu_count() or 1 if args.nworkers == "auto" else int(args.nworkers)
    )
    join_env = join_environment(args)
    if join_env and nworkers != 1:
        # one rank maps to ONE worker process: several workers sharing a
        # rank either double-join the rendezvous (--nanny) or report
        # overlapping device ownership, breaking the device plane in
        # confusing ways downstream
        raise SystemExit(
            "--master-addr requires --nworkers 1 (one worker process "
            "per rank); start one dtpu-worker per card"
        )
    from distributed_tpu_torch import config

    if join_env:
        # the worker joins from a config preload, before it registers.
        # Under --nanny the PARENT must NOT join — the nanny-spawned
        # worker child joins, reading the preload and the rendezvous from
        # the environment it inherits; a double join at one rank fails
        # at the rendezvous
        preloads = [*(config.get("worker.preload") or []), JOIN_PRELOAD]
        os.environ.update(join_env, DTPU_WORKER__PRELOAD=repr(preloads))
        if not args.nanny:
            config.set({"worker.preload": preloads})

    resources = json.loads(args.resources) if args.resources else None
    memory_limit = parse_memory_limit(args.memory_limit, nworkers)
    # None = defer to the worker.lifetime.* config keys
    lifetime = config.parse_timedelta(args.lifetime) if args.lifetime else None
    lifetime_stagger = (
        config.parse_timedelta(args.lifetime_stagger)
        if args.lifetime_stagger is not None else None
    )
    host = args.host
    if host == "auto":
        # the interface this host routes to the scheduler through: works
        # for ssh aliases / jump hosts where the ssh destination name is
        # not resolvable on the worker machine itself
        from distributed_tpu_torch.utils.system import outbound_ip

        host = outbound_ip(args.scheduler)
    # match the scheduler's transport: a tls:// control plane means the
    # worker must serve its peers over tls too
    proto = args.scheduler.split("://", 1)[0] if "://" in args.scheduler else "tcp"
    if (args.tls_ca_file or args.tls_cert) and proto == "tcp":
        # mirror the scheduler CLI: supplying TLS credentials means an
        # encrypted cluster — silently running the whole data plane in
        # plaintext because the address said tcp:// is a foot-gun
        rest = args.scheduler.split("://", 1)[-1]
        args.scheduler = f"tls://{rest}"
        proto = "tls"
        logging.getLogger("distributed_tpu_torch.cli").info(
            "TLS credentials provided: scheduler address upgraded to %s",
            args.scheduler,
        )
    if host:
        listen_addr = f"{proto}://{host}:0"
    elif proto != "tcp":
        listen_addr = f"{proto}://127.0.0.1:0"
    else:
        listen_addr = None
    security = None
    if args.tls_ca_file or args.tls_cert:
        from distributed_tpu_torch.security import Security

        security = Security(
            tls_ca_file=args.tls_ca_file,
            tls_worker_cert=args.tls_cert,
            tls_worker_key=args.tls_key,
            require_encryption=True,
        )
        if proto != "tls":
            logging.getLogger("distributed_tpu_torch.cli").warning(
                "TLS credentials given but the scheduler address is %s://"
                " — traffic will NOT be encrypted; use a tls:// address",
                proto,
            )

    servers = []
    all_preloads = []
    for i in range(nworkers):
        name = (
            f"{args.name}-{i}" if args.name and nworkers > 1
            else args.name or None
        )
        worker_kwargs = {}
        if resources:
            worker_kwargs["resources"] = resources
        if listen_addr:
            worker_kwargs["listen_addr"] = listen_addr
        if security is not None:
            worker_kwargs["security"] = security
        if args.nanny:
            server = Nanny(
                args.scheduler,
                nthreads=args.nthreads,
                name=name,
                memory_limit=memory_limit,
                worker_kwargs=worker_kwargs,
                lifetime=lifetime,
                lifetime_stagger=lifetime_stagger,
                lifetime_restart=args.lifetime_restart,
                security=security,
            )
        else:
            server = Worker(
                args.scheduler,
                nthreads=args.nthreads,
                name=name,
                memory_limit=memory_limit,
                lifetime=lifetime,
                lifetime_stagger=lifetime_stagger,
                **worker_kwargs,
            )
        await server.start()
        # preloads run with the server live (dtpu_setup may read .address)
        preloads = process_preloads(server, args.preload)
        for preload in preloads:
            await preload.start()
        all_preloads.extend(preloads)
        servers.append(server)
        addr = getattr(server, "worker_address", None) or server.address
        print(f"Worker at: {addr}", flush=True)

    loop = asyncio.get_running_loop()
    stop = asyncio.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    waiters = [asyncio.ensure_future(s.finished()) for s in servers]
    stopper = asyncio.ensure_future(stop.wait())
    await asyncio.wait({*waiters, stopper}, return_when=asyncio.FIRST_COMPLETED)
    for preload in all_preloads:
        await preload.teardown()
    for s in servers:
        await s.close()
    stopper.cancel()
    return 0


def main(argv: list[str] | None = None) -> int:
    args = make_parser().parse_args(argv)
    if args.version:
        from distributed_tpu_torch import __version__

        print(__version__)
        return 0
    logging.basicConfig(
        level=args.log_level.upper(),
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )
    return asyncio.run(run(args))


if __name__ == "__main__":
    sys.exit(main())
