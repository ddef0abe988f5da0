"""The ``dtpu_build_info`` gauge of a worker or scheduler that runs the port.

The counterpart of ``distributed_tpu/http/server.py:353-393``, the
always-1 identity gauge on ``/metrics``, with the port's runtime in its
labels: ``role``, ``version`` (the port's ``__version__``), ``torch``,
``cuda`` (``torch.version.cuda``), ``backend`` (``cuda`` or ``cpu``),
``device`` (the card's name) and ``mesh``.  The reference's labels fall
back to ``""`` when jax does not import; torch always imports in the port,
so no label here has a fallback.

The port's own ``/metrics`` routes reach :func:`build_info_lines`
through ``http/server.py``'s.  :func:`install_build_info` rebinds the
reference's module-level ``build_info_lines`` (its ``/metrics`` routes
call it by name, ``:722,982``), computing ``mesh`` through the
reference's ``config.get``, passed in, as the reference does
(``:379-382``).
"""

from __future__ import annotations

import torch

from distributed_tpu_torch import __version__
from distributed_tpu_torch._device import resolve_device
from distributed_tpu_torch._install import Installed, install
from distributed_tpu_torch.http.server import prom_line

HELP = ("Build/runtime identity (always 1; labels carry the port's version, torch, CUDA, "
        "backend, device and engine-mesh layout)")


def build_info_lines(role: str, *, mesh: str, device=None) -> list[str]:
    """``[the dtpu_build_info gauge]`` for ``role`` on ``device`` (CUDA for
    None, which raises without a card)."""
    dev = resolve_device(device)
    labels = {
        "role": role,
        "version": __version__,
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
        "backend": dev.type,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "mesh": mesh,
    }
    return [prom_line("dtpu_build_info", 1, labels, help_=HELP, type_="gauge")]


def install_build_info(http_server_module, config_get, device=None) -> Installed:
    """Rebind ``http_server_module.build_info_lines`` to the port's gauge
    and clear its ``_BUILD_INFO_CACHE``; the port's lines are then
    computed once a role into that cache, as the reference's are.  The
    handle's last ``uninstall()`` puts back the module's own function (the
    same object) and clears the cache again."""
    dev = resolve_device(device)
    cache = http_server_module._BUILD_INFO_CACHE

    def lines(role: str) -> list[str]:
        cached = cache.get(role)
        if cached is None:
            mesh = (f"{config_get('scheduler.jax.mesh.enabled')}"
                    f"/{config_get('scheduler.jax.mesh.layout')}")
            cached = cache[role] = build_info_lines(role, mesh=mesh, device=dev)[0]
        return [cached]

    def apply():
        original = http_server_module.build_info_lines
        http_server_module.build_info_lines = lines
        cache.clear()

        def undo():
            http_server_module.build_info_lines = original
            cache.clear()

        return undo

    return install("build_info", http_server_module, (str(dev),), apply)
