"""The port's fleet mirror (``distributed_tpu_torch/scheduler/mirror.py``,
``TorchMirror``) against the reference's ``SchedulerMirror``, on the CPU.

- The random transition + churn trace of ``tests/test_mirror.py`` driven
  twice from one seed, once on a state whose mirror the port adopted and
  once on the reference's: after every step the two mirrors hold **the
  same rows bit for bit** (every field, the slot of every worker, the
  free list, the capacity), the port's passes its oracle check, and its
  device view (CPU tensors) equals its host rows.
- The reference's counter contracts (``tests/test_mirror.py:236-262``): a
  fresh cycle refreshes and uploads nothing, one changed worker one row,
  a full upload only at first use and after growth.
- ``adopt`` keeps every ``WorkerState.idx`` and the pending dirty rows.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from distributed_tpu.scheduler.mirror import FIELDS as REF_FIELDS
from distributed_tpu.scheduler.mirror import SchedulerMirror
import test_torch_periodic_cases as pc
from distributed_tpu_torch.scheduler import mirror as tm
from distributed_tpu_torch.scheduler.mirror import MirrorParityError, TorchMirror

from test_mirror import _flip_status, _state, _submit

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)


def _trace_step(state, rng, step, graph_n):
    """One step of tests/test_mirror.py's random trace; returns graph_n."""
    op = rng.random()
    workers = list(state.workers.values())
    if op < 0.06 and len(workers) < 12:
        state.add_worker_state(f"tcp://127.0.0.1:{20000 + step}",
                               nthreads=rng.choice([1, 2, 4]), memory_limit=2**30)
    elif op < 0.10 and len(workers) > 1:
        state.remove_worker_state(rng.choice(workers).address, stimulus_id=f"rm-{step}", safe=True)
    elif op < 0.13 and workers:
        state.set_worker_nthreads(rng.choice(workers), rng.choice([1, 2, 3, 4]))
    elif op < 0.18 and workers:
        ws = rng.choice(workers)
        _flip_status(state, ws, "paused" if ws in state.running else "running")
    elif op < 0.28:
        graph_n += 1
        _submit(state, rng, rng.randint(4, 12), f"g{graph_n}")
    elif op < 0.34:
        mem = [ts for ts in state.tasks.values() if ts.state == "memory"]
        if mem and workers:
            ts, ws = rng.choice(mem), rng.choice(workers)
            if ws in ts.who_has:
                if len(ts.who_has) > 1:
                    state.remove_replica(ts, ws)
            else:
                state.add_replica(ts, ws)
    else:
        processing = [ts for ts in state.tasks.values() if ts.state == "processing"]
        if processing:
            ts = rng.choice(processing)
            if rng.random() < 0.85:
                state.stimulus_task_finished(ts.key, worker=ts.processing_on.address,
                                             stimulus_id=f"fin-{step}",
                                             nbytes=rng.randint(1, 10_000), typename="int")
            else:
                state.stimulus_task_erred(ts.key, worker=ts.processing_on.address,
                                          stimulus_id=f"err-{step}", exception_text="boom")
    return graph_n


def test_fields_are_the_references():
    assert [(n, np.dtype(d)) for n, d in tm.FIELDS] == [(n, np.dtype(d)) for n, d in REF_FIELDS]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mirror_rows_equal_reference_on_random_trace(seed):
    rngs = [random.Random(seed), random.Random(seed)]
    threads = rngs[0].choice([1, 2])
    rngs[1].choice([1, 2])
    states = [_state(n_workers=3, nthreads=threads) for _ in range(2)]
    port = TorchMirror.adopt(states[0], device="cpu")
    ref = states[1].mirror
    assert isinstance(ref, SchedulerMirror)
    graph_n = [0, 0]
    for step in range(250):
        for i in range(2):
            graph_n[i] = _trace_step(states[i], rngs[i], step, graph_n[i])
        port.verify()
        ref.verify()
        assert port.cap == ref.cap and port._free == ref._free
        assert port.addrs == ref.addrs
        for (name, _), a, b in zip(tm.FIELDS, (getattr(port, n) for n, _ in tm.FIELDS),
                                   (getattr(ref, n) for n, _ in tm.FIELDS)):
            assert a.dtype == b.dtype and np.array_equal(a, b), (step, name)
        assert {a: ws.idx for a, ws in states[0].workers.items()} == \
            {a: ws.idx for a, ws in states[1].workers.items()}
        if step % 25 == 0:
            view = port.device_view()
            for name in tm.DEVICE_FIELDS:
                assert torch.equal(view[name], torch.from_numpy(getattr(port, name)))
    assert port.oracle_failures == 0 and port.deltas_applied > 0


def test_check_mode_catches_an_unmarked_mutation():
    state = _state(n_workers=3)
    m = TorchMirror.adopt(state, device="cpu")
    m.check = True
    m.fleet_view()
    ws = next(iter(state.workers.values()))
    ws.occupancy += 1.0  # graft-lint: allow[mirror-parity] deliberately unmarked to prove the check fires
    with pytest.raises(MirrorParityError):
        m.fleet_view()
    assert m.oracle_failures == 1
    m.mark(ws)
    m.fleet_view()


def test_adopt_keeps_slots_and_pending_rows():
    state = _state(n_workers=6)
    for addr in list(state.workers)[1:4:2]:
        state.remove_worker_state(addr, stimulus_id="t", safe=True)
    ws = next(iter(state.workers.values()))
    state._adjust_occupancy(ws, 2.0)  # a pending dirty row
    old = state.mirror
    slots = {a: w.idx for a, w in state.workers.items()}
    m = TorchMirror.adopt(state, device="cpu")
    assert state.mirror is m and m is not old
    assert {a: w.idx for a, w in state.workers.items()} == slots
    assert m._free == old._free and m._next_slot == old._next_slot and m.cap == old.cap
    assert ws.idx in m._dirty
    m.verify()
    fresh = state.add_worker_state("tcp://fresh:1", nthreads=2)
    assert fresh.idx == old._free[-1]  # the tombstone is reused, LIFO
    m.verify()
    assert m.sharded_stats() == {"n_shards": 0, "rows_uploaded": [], "bytes_uploaded": [],
                                 "full_packs": []}


def test_adopt_needs_a_mirror():
    with pytest.raises(ValueError, match="no mirror"):
        TorchMirror.adopt(_state(n_workers=2, mirror=False), device="cpu")


def test_fresh_cycle_uploads_nothing():
    """tests/test_mirror.py:236-262 on the port's mirror."""
    state = _state(n_workers=8, nthreads=2)
    m = TorchMirror.adopt(state, device="cpu")
    m.fleet_view()
    m.device_view()
    base = m.stats()
    m.fleet_view()
    m.device_view()
    after = m.stats()
    for key in ("rows_refreshed", "rows_uploaded", "full_uploads"):
        assert after[key] == base[key], key
    assert after["oracle_packs"] == 0
    ws = next(iter(state.workers.values()))
    state._adjust_occupancy(ws, 1.5)
    m.fleet_view()
    view = m.device_view()
    after2 = m.stats()
    assert after2["rows_refreshed"] == after["rows_refreshed"] + 1
    assert after2["rows_uploaded"] == after["rows_uploaded"] + 1
    assert after2["full_uploads"] == after["full_uploads"]
    assert after2["bytes_uploaded"] - after["bytes_uploaded"] == 4 + 4 + 1 + 1
    assert float(view["occupancy"][ws.idx]) == np.float32(ws.occupancy)


@pytest.mark.parametrize("dirty", [0, 1, 37, "all"])
def test_device_view_uploads_exactly_the_dirty_rows(dirty):
    """On the stand-in fleet (no scheduler): the view equals the host rows;
    the first view and the one after growth are the only full uploads."""
    rng = np.random.default_rng(0)
    state = pc.StandInState()
    m = state.mirror = TorchMirror(state, device="cpu")
    workers = [state.add_worker(f"w{i}", 2) for i in range(512)]
    assert m.cap == 512
    m.device_view()
    assert m.stats()["full_uploads"] == 1
    pick = workers if dirty == "all" else rng.choice(workers, dirty, replace=False)
    for ws in pick:
        state.update(ws, rng)
    before = m.stats()
    view = m.device_view()
    after = m.stats()
    assert after["rows_uploaded"] - before["rows_uploaded"] == len(pick)
    assert after["full_uploads"] == before["full_uploads"]
    for name in tm.DEVICE_FIELDS:
        assert torch.equal(view[name], torch.from_numpy(getattr(m, name)))
    workers += [state.add_worker(f"g{i}", 1) for i in range(488)]
    view = m.device_view()
    assert m.cap == 1024 and m.stats()["full_uploads"] == 2
    for name in tm.DEVICE_FIELDS:
        assert torch.equal(view[name], torch.from_numpy(getattr(m, name)))


def test_mirror_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchMirror.adopt(_state(n_workers=2))
