"""``dtpu-spec``: launch servers from a JSON spec (reference cli/dask_spec.py).

    python -m distributed_tpu_torch.cli.spec --spec \
      '{"cls": "distributed_tpu_torch.worker.server.Worker", \
        "opts": {"nthreads": 2}}' tcp://127.0.0.1:8786
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import signal
import sys


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dtpu-spec", description="run a server from a JSON spec"
    )
    p.add_argument("args", nargs="*", help="positional args for the class")
    p.add_argument("--spec", default=None, help='JSON: {"cls": "mod.Class", "opts": {}}')
    p.add_argument("--spec-file", default=None, help="path to a JSON spec file")
    p.add_argument("--log-level", default="INFO")
    return p


async def run(args: argparse.Namespace) -> int:
    from distributed_tpu_torch.utils.misc import import_term

    if args.spec_file:
        # graft-lint: allow[blocking-in-async] CLI startup, nothing else on the loop yet
        with open(args.spec_file) as f:
            spec = json.load(f)
    elif args.spec:
        spec = json.loads(args.spec)
    else:
        raise SystemExit("one of --spec / --spec-file is required")

    specs = spec if isinstance(spec, list) else [spec]
    servers = []
    for s in specs:
        cls = import_term(s["cls"])
        server = cls(*args.args, **s.get("opts", {}))
        await server.start()
        print(f"Server at: {getattr(server, 'address', server)}", flush=True)
        servers.append(server)

    loop = asyncio.get_running_loop()
    stop = asyncio.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    waiters = [asyncio.ensure_future(s.finished()) for s in servers]
    stopper = asyncio.ensure_future(stop.wait())
    await asyncio.wait({*waiters, stopper}, return_when=asyncio.FIRST_COMPLETED)
    for s in servers:
        await s.close()
    stopper.cancel()
    return 0


def main(argv: list[str] | None = None) -> int:
    args = make_parser().parse_args(argv)
    logging.basicConfig(level=args.log_level.upper())
    return asyncio.run(run(args))


if __name__ == "__main__":
    sys.exit(main())
