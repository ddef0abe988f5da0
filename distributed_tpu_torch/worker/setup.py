"""Everything a worker of the port sets up, in one call from a preload.

:func:`setup_worker` joins the process group (``worker/join.py``), then
installs the tensor ``sizeof`` rule, the ``"torch"`` wire family and the
device trace onto the reference's objects, which the caller passes in: the
port imports nothing of the reference.  A deployment calls it from a
config preload (``worker.preload``, run before the worker registers; the
CLI's ``--preload`` runs after, too late for the join).  The README shows
that preload's source.
"""

from __future__ import annotations

from distributed_tpu_torch._install import Installed
from distributed_tpu_torch.diagnostics.device_profile import install_device_profile
from distributed_tpu_torch.protocol.serialize import install_serialization
from distributed_tpu_torch.utils.sizeof import install_sizeof
from distributed_tpu_torch.worker.join import hold_process_group


class WorkerSetup:
    """The installs of one worker, its hold on the process group first;
    ``uninstall()`` gives them back in the reverse of their order.  Each is
    counted across the workers of the process: the last worker's teardown
    removes the installs and destroys the group the joins created."""

    def __init__(self):
        self.handles: list[Installed] = []

    def uninstall(self) -> None:
        while self.handles:
            self.handles.pop().uninstall()


async def setup_worker(worker, *, sizeof, register_serialization_family, families,
                       device_profile, device=None) -> WorkerSetup:
    """Join the process group, then install onto the reference's
    ``sizeof`` function, its serialization registry
    (``register_serialization_family``, ``families``) and its
    ``device_profile`` module.  ``device=None`` means CUDA and raises
    without a card; ``device="cpu"`` joins over gloo and traces the CPU."""
    setup = WorkerSetup()
    group = await hold_process_group(worker, device=device)
    if group is not None:
        setup.handles.append(group)
    try:
        setup.handles.append(install_sizeof(sizeof))
        setup.handles.append(install_serialization(register_serialization_family, families))
        setup.handles.append(install_device_profile(device_profile, device=device))
    except BaseException:
        setup.uninstall()
        raise
    return setup
