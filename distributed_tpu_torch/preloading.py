"""Preload: run user code at server startup (reference preloading.py).

A preload is a module name, a file path, or raw source text.  At server
start it is imported/exec'd and its ``dtpu_setup(server)`` /
``dtpu_teardown(server)`` hooks are called (the reference's
``dask_setup``/``dask_teardown``, preloading.py:154,225).  Configured per
server class via ``scheduler.preload`` / ``worker.preload`` / CLI flags.
"""

from __future__ import annotations

import asyncio
import importlib
import logging
import os
import sys
import types
from typing import Any

logger = logging.getLogger("distributed_tpu_torch.preload")


def _exec_module(source: str, filename: str, key: str) -> types.ModuleType:
    name = f"_dtpu_preload_{abs(hash(key)) % 10**8}"
    module = types.ModuleType(name)
    exec(compile(source, filename, "exec"), module.__dict__)
    sys.modules[name] = module
    return module


def _load_module(spec: str) -> types.ModuleType:
    if spec.endswith(".py") or os.path.sep in spec and os.path.exists(spec):
        with open(spec) as f:
            return _exec_module(f.read(), spec, spec)
    if "\n" in spec or ";" in spec:
        return _exec_module(spec, "<preload>", spec)
    return importlib.import_module(spec)


class Preload:
    """One preload attached to one server (reference preloading.py:154)."""

    def __init__(self, server: Any, spec: str, argv: list[str] | None = None):
        self.server = server
        self.spec = spec
        self.argv = argv or []
        self.module: types.ModuleType | None = None

    async def start(self) -> None:
        logger.info("loading preload %r", self.spec)
        self.module = _load_module(self.spec)
        setup = getattr(self.module, "dtpu_setup", None)
        if setup is not None:
            result = setup(self.server)
            if asyncio.iscoroutine(result):
                await result

    async def teardown(self) -> None:
        if self.module is None:
            return
        teardown = getattr(self.module, "dtpu_teardown", None)
        if teardown is not None:
            result = teardown(self.server)
            if asyncio.iscoroutine(result):
                await result


def process_preloads(server: Any, specs: list[str] | str | None,
                     argv: list[str] | None = None) -> list[Preload]:
    if not specs:
        return []
    if isinstance(specs, str):
        specs = [specs]
    return [Preload(server, spec, argv) for spec in specs]
