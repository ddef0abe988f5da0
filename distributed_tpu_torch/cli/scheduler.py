"""``dtpu-scheduler``: run a scheduler process (reference cli/dask_scheduler.py).

    python -m distributed_tpu_torch.cli.scheduler --host 0.0.0.0 --port 8786

The port's copy of ``distributed_tpu/cli/scheduler.py``, line for line but
for ``--device``: the scheduler's device (its fleet mirror, placement and
periodic device paths), the card by default, which raises without one;
``--device cpu`` runs the plain versions.  The reference's backend is
whatever jax picks.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal
import sys


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dtpu-scheduler", description="distributed_tpu_torch scheduler"
    )
    p.add_argument("--host", default="127.0.0.1", help="listen host")
    p.add_argument("--port", type=int, default=8786, help="listen port (0=random)")
    p.add_argument("--protocol", default="tcp", help="comm protocol (tcp, tls)")
    p.add_argument("--device", default=None,
                   help="device of the scheduler's kernels (default: the CUDA "
                        "device, which must exist; 'cpu' runs the plain versions)")
    p.add_argument("--idle-timeout", default=None,
                   help="shut down after this long with no activity (e.g. '5min')")
    p.add_argument("--worker-ttl", default=None,
                   help="evict workers silent for this long")
    p.add_argument("--preload", action="append", default=[],
                   help="module to import (dtpu_setup hook) at startup")
    p.add_argument("--jupyter", action="store_true", default=False,
                   help="run a Jupyter server on the scheduler host, "
                        "lifecycle-tied to the scheduler "
                        "(reference scheduler.py:3663 --jupyter)")
    p.add_argument("--jupyter-port", type=int, default=8888,
                   help="port for the Jupyter server (with --jupyter)")
    p.add_argument("--tls-ca-file", default=None,
                   help="CA certificate for TLS (with --protocol tls)")
    p.add_argument("--tls-cert", default=None, help="scheduler TLS certificate")
    p.add_argument("--tls-key", default=None, help="scheduler TLS private key")
    p.add_argument("--log-level", default="INFO")
    p.add_argument("--version", action="store_true")
    return p


async def run(args: argparse.Namespace) -> int:
    from distributed_tpu_torch import config
    from distributed_tpu_torch.preloading import process_preloads
    from distributed_tpu_torch.scheduler.server import Scheduler

    kwargs = {}
    if args.idle_timeout is not None:
        kwargs["idle_timeout"] = config.parse_timedelta(args.idle_timeout)
    if args.worker_ttl is not None:
        kwargs["worker_ttl"] = config.parse_timedelta(args.worker_ttl)
    if args.tls_ca_file or args.tls_cert:
        from distributed_tpu_torch.security import Security

        kwargs["security"] = Security(
            tls_ca_file=args.tls_ca_file,
            tls_scheduler_cert=args.tls_cert,
            tls_scheduler_key=args.tls_key,
            require_encryption=True,
        )
        if args.protocol == "tcp":
            # certs given but protocol left at the default: a tcp://
            # listener would silently drop the ssl context and run the
            # whole cluster in plaintext — infer tls like the reference
            logging.getLogger("distributed_tpu_torch.cli").info(
                "TLS credentials given: using protocol tls"
            )
            args.protocol = "tls"
    scheduler = Scheduler(
        listen_addr=f"{args.protocol}://{args.host}:{args.port}",
        device=args.device, **kwargs
    )
    await scheduler.start()
    # preloads run with the server live (dtpu_setup may read .address)
    preloads = process_preloads(scheduler, args.preload)
    for preload in preloads:
        await preload.start()
    print(f"Scheduler at: {scheduler.address}", flush=True)

    jupyter_proc = None
    if args.jupyter:
        jupyter_proc = await _start_jupyter(args.host, args.jupyter_port)

    loop = asyncio.get_running_loop()
    stop = asyncio.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    finished = asyncio.ensure_future(scheduler.finished())
    stopper = asyncio.ensure_future(stop.wait())
    await asyncio.wait({finished, stopper}, return_when=asyncio.FIRST_COMPLETED)
    for preload in preloads:
        await preload.teardown()
    if jupyter_proc is not None and jupyter_proc.returncode is None:
        jupyter_proc.terminate()
        try:
            await asyncio.wait_for(jupyter_proc.wait(), 10)
        except asyncio.TimeoutError:
            jupyter_proc.kill()
    await scheduler.close()
    stopper.cancel()
    return 0


async def _start_jupyter(host: str, port: int):
    """Launch a Jupyter server next to the scheduler (the reference embeds
    one in the scheduler's HTTP app, scheduler.py:3663-3690; here it is a
    lifecycle-tied child process, same operator capability)."""
    try:
        import jupyter_server  # noqa: F401
    except ImportError:
        print("Jupyter not available: pip install jupyter-server", flush=True)
        return None
    import os

    argv = [
        sys.executable, "-m", "jupyter_server",
        f"--ServerApp.ip={host}",
        f"--ServerApp.port={port}",
        "--ServerApp.open_browser=False",
    ]
    if hasattr(os, "geteuid") and os.geteuid() == 0:
        argv.append("--allow-root")
    proc = await asyncio.create_subprocess_exec(*argv)
    print(f"Jupyter at: http://{host}:{port}/", flush=True)
    return proc


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
