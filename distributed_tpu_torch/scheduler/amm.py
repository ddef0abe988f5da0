"""The Active Memory Manager's replica drops on the card, bound onto the
scheduler's ``ReduceReplicas`` policies.

The port's own copies of the reference's ``ReduceReplicas.run`` and
``_run_device`` (``distributed_tpu/scheduler/amm.py:303-393``), installed
on a policy *instance* by :func:`install_amm`.  ``run`` keeps the
reference's gate (explicit parameters here, see ``gate.py``) and its
python generator for the cycles the gate keeps on the host; the device
round builds the replica matrix over the mirror's slots and plans all
drops in one call of ``ops/amm.py::plan_drops`` (kernel K8 on the card).
Each suggestion still passes the manager's ``_find_dropper`` guards.

No ``except`` swallows a failure of the device round: it is counted in
``failures``, kept in ``errors`` and raised out of the policy's
generator.  (The manager's ``run_once`` then logs a failing policy, as it
does for any policy.)
"""

from __future__ import annotations

import functools

import numpy as np

from distributed_tpu_torch._device import resolve_device
from distributed_tpu_torch.ops import amm as ops_amm
from distributed_tpu_torch.scheduler.gate import DevicePath
from distributed_tpu_torch.scheduler.stealing import ensure_mirror


class AmmPath(DevicePath):
    """The device path of one or more ``ReduceReplicas`` policies."""

    def __init__(self, device=None, **gate):
        super().__init__(resolve_device(device), **gate)

    def run(self, policy):
        """The policy's round (the reference's ``ReduceReplicas.run``)."""
        state = policy.manager.state
        replicated = list(state.replicated_tasks)
        if self.worthwhile(len(state.workers), len(replicated), policy.DEVICE_MIN_TASKS):
            self.cycles_device += 1
            try:
                yield from self.run_device(policy, replicated)
            except Exception as exc:
                self.fail(exc)
                raise
            return
        self.cycles_host += 1
        for ts in replicated:
            ndrop = len(ts.who_has) - policy._desired(ts)
            for _ in range(ndrop):
                yield ("drop", ts, None)

    def run_device(self, policy, replicated: list):
        """The whole round's drops in one plan (the reference's
        ``_run_device``): the worker axis is the mirror's slot space when
        the state has a mirror, else the live workers in order."""
        state = policy.manager.state
        mirror = ensure_mirror(state, self.device)
        rows = []
        for ts in replicated:
            ndrop = len(ts.who_has) - policy._desired(ts)
            if ndrop > 0:
                rows.append((ts, ndrop))
        if not rows:
            return
        R = len(rows)
        if mirror is not None:
            fv = mirror.fleet_view()
            W = mirror.cap
            ws_of = fv.ws_of
            slot = lambda ws: ws.idx  # noqa: E731
            mem = fv.nbytes.astype(np.float32, copy=True)
            for ws, v in policy.manager.workers_memory.items():
                if ws.idx >= 0:
                    mem[ws.idx] = v
        else:
            workers = list(state.workers.values())
            widx = {ws: i for i, ws in enumerate(workers)}
            W = len(workers)
            ws_of = workers
            slot = lambda ws: widx.get(ws, -1)  # noqa: E731
            mem = np.asarray([policy.manager._projected(ws) for ws in workers], np.float32)
        holders = np.zeros((R, W), bool)
        excluded = np.zeros((R, W), bool)
        nbytes = np.zeros(R, np.float32)
        ndrops = np.zeros(R, np.int32)
        for r, (ts, ndrop) in enumerate(rows):
            for ws in ts.who_has:
                i = slot(ws)
                if i >= 0:
                    holders[r, i] = True
            for waiter in ts.waiters:
                pw = waiter.processing_on
                if pw is not None:
                    i = slot(pw)
                    if i >= 0:
                        excluded[r, i] = True
            nbytes[r] = ts.get_nbytes()
            ndrops[r] = ndrop
        drops = ops_amm.plan_drops(
            ops_amm.DropBatch(holders, excluded, nbytes, ndrops, mem), device=self.device
        )
        self.launches += 1
        for r, w in drops:
            dropper = ws_of[w]
            if dropper is not None:
                yield ("drop", rows[r][0], {dropper})


def install_amm(policy, device=None, *, path: AmmPath | None = None, **gate) -> AmmPath:
    """Bind the port's device path onto the ``ReduceReplicas`` instance
    ``policy`` and return it (``path`` shares one path's counters among
    several policies).  ``gate`` holds the gate's parameters;
    ``device=None`` means CUDA and raises without one."""
    path = path or AmmPath(device, **gate)
    policy.run = functools.partial(path.run, policy)
    policy._run_device = functools.partial(path.run_device, policy)
    return path
