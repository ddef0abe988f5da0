"""The scheduler's rebalance move selection on the card (K9,
``ops/csrc/rebalance.cu``, one launch a plan).

The port's own copy of the reference's ``Scheduler._rebalance_plan_device``
(``distributed_tpu/scheduler/server.py:2005-2033``), set by
:func:`install_rebalance` as an attribute of the ``Scheduler`` instance,
where ``Scheduler.rebalance`` calls it as
``self._rebalance_plan_device(wss, cand, owner, mem)``.  The gate that
picks it stays the reference's (in ``Scheduler.rebalance``, from the
scheduler's configuration: at least 512 movable candidates); the
instance's ``_rebalance_plan_python`` is wrapped only to count the cycles
that gate keeps on the host.  A failure of the device plan is counted and
raised.
"""

from __future__ import annotations

import numpy as np

from distributed_tpu_torch._device import resolve_device
from distributed_tpu_torch.ops.rebalance import RebalanceBatch, plan_moves
from distributed_tpu_torch.scheduler.gate import DevicePath


class RebalancePath(DevicePath):
    """The device path of one ``Scheduler``'s ``rebalance`` (its gate is
    the scheduler's own)."""

    def __init__(self, device=None):
        super().__init__(resolve_device(device))

    def plan_device(self, wss: list, cand: list, owner: list[int], mem=None) -> list[tuple]:
        """Vectorized move selection (the reference's
        ``_rebalance_plan_device``): ``[(ts, sender, recipient)]``.  ``mem``
        is the mirror's projected-memory gather when the caller has one."""
        self.cycles_device += 1
        if not cand:
            return []
        if mem is None:
            mem = np.asarray([ws.nbytes for ws in wss], np.float32)
        batch = RebalanceBatch(
            owner=np.asarray(owner, np.int32),
            nbytes=np.asarray([ts.get_nbytes() for ts in cand], np.float32),
            eligible=np.ones(len(cand), bool),
            mem=mem,
        )
        try:
            keys, senders, recipients = plan_moves(batch, device=self.device)
        except Exception as exc:
            self.fail(exc)
            raise
        self.launches += 1
        return [(cand[k], wss[s], wss[r])
                for k, s, r in zip(keys.tolist(), senders.tolist(), recipients.tolist())]


def install_rebalance(scheduler, device=None) -> RebalancePath:
    """Set the port's ``_rebalance_plan_device`` on the ``Scheduler``
    instance and return its path; ``device=None`` means CUDA and raises
    without one."""
    path = RebalancePath(device)
    python_plan = type(scheduler)._rebalance_plan_python

    def plan_python(wss, keyset):
        path.cycles_host += 1
        return python_plan(wss, keyset)

    scheduler._rebalance_plan_device = path.plan_device
    scheduler._rebalance_plan_python = plan_python
    return path
