"""The port's device shuffle (``distributed_tpu_torch/shuffle/device.py``)
against the reference's (``distributed_tpu/shuffle/device.py``), on the
CPU: the port's runs on 8 CPU shards, the reference's on the conftest's 8
virtual XLA CPU devices.

Tolerance: none.  ``DeviceRun`` outputs on ragged partitions equal the
reference's bit for bit; each rule of ``DeviceShuffleStore`` gives the
same answers to the same calls on both stores; and a ``LocalCluster`` run
of the port's ``p2p_shuffle_device`` (through ``install_device_shuffle``)
routes every row to ``mix32(key) % 8``, values riding along.

The divergences the port needs to plug into the reference's cluster, each
shown here: transfers and the barrier are restricted to the installed
workers (``test_transfers_and_barrier_are_restricted_to_installed_workers``),
an output owner that is not installed is refused before anything runs
(``test_p2p_shuffle_device_refuses_an_output_owner_not_installed``), and a body with
no running installed worker in its process raises
(``test_body_without_an_installed_worker_raises``).
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest
import torch

from distributed_tpu.client.client import Client, wait as wait_futures
from distributed_tpu.deploy.local import LocalCluster
from distributed_tpu.exceptions import Reschedule
from distributed_tpu.shuffle import device as ref_device
from distributed_tpu_torch.ops import ici
from distributed_tpu_torch.shuffle import device

from conftest import gen_test

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)


N_DEV = 8
CPU8 = ["cpu"] * N_DEV


def _parts(lengths, seed=0, width=3):
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(lengths):
        keys = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(np.int32)
        values = rng.standard_normal((n, width)).astype(np.float32)
        values[:, 0] = i
        out.append((keys, values))
    return out


@pytest.mark.parametrize("lengths", [[40, 3, 0, 17, 64, 64, 1, 33], [16] * 8, [0] * 7 + [5]],
                         ids=["ragged", "even", "one_nonempty"])
def test_device_run_equals_reference(lengths):
    parts = _parts(lengths, seed=len(lengths) + sum(lengths))
    want_run = ref_device.DeviceRun("s", 1, N_DEV, N_DEV)
    got_run = device.DeviceRun("s", 1, N_DEV, N_DEV, devices=CPU8)
    for i, (k, v) in enumerate(parts):
        want_run.register(i, k, v)
        got_run.register(i, torch.from_numpy(k), torch.from_numpy(v))
    want_run.exchange()
    got_run.exchange()
    assert got_run.local_ids == want_run.local_ids == list(range(N_DEV))
    for d in range(N_DEV):
        wk, wv = (np.asarray(x) for x in want_run.outputs[d])
        gk, gv = got_run.outputs[d]
        assert gk.dtype == torch.int32 and gk.device.type == "cpu"
        np.testing.assert_array_equal(gk.numpy(), wk)
        np.testing.assert_array_equal(gv.numpy().view(np.uint8), wv.view(np.uint8))
    assert sum(len(got_run.outputs[d][0]) for d in range(N_DEV)) == sum(lengths)
    got_run.exchange()  # idempotent per epoch
    assert got_run.outputs is not None


def test_device_run_exchange_with_global_max_n_equals_reference():
    """The barrier passes the global longest partition as ``max_n``."""
    parts = _parts([5, 9, 2, 0, 7, 7, 1, 3], seed=11)
    want_run = ref_device.DeviceRun("s", 2, N_DEV, N_DEV)
    got_run = device.DeviceRun("s", 2, N_DEV, N_DEV, devices=CPU8)
    for i, (k, v) in enumerate(parts):
        want_run.register(i, k, v)
        got_run.register(i, torch.from_numpy(k), torch.from_numpy(v))
    want_run.exchange(max_n=12)
    got_run.exchange(max_n=12)
    for d in range(N_DEV):
        np.testing.assert_array_equal(got_run.outputs[d][0].numpy(),
                                      np.asarray(want_run.outputs[d][0]))


def test_device_run_refuses_missing_registrations():
    run = device.DeviceRun("s", 1, N_DEV, N_DEV, devices=CPU8)
    for i, (k, v) in enumerate(_parts([4] * 7)):
        run.register(i, torch.from_numpy(k), torch.from_numpy(v))
    with pytest.raises(RuntimeError, match="registered partitions"):
        run.exchange()


# ----------------------------------------------------------- store rules


def _both():
    return ref_device.DeviceShuffleStore(), device.DeviceShuffleStore(devices=CPU8)


def _served(store, run_obj, pids):
    for p in pids:
        store.mark_served(run_obj, p)


def _rule_epoch_fencing(store):
    a = store.get_or_create("x", 1, 2, 2)
    b = store.get_or_create("x", 1, 2, 2)
    c = store.get_or_create("x", 2, 2, 2)  # a newer epoch drops the older run
    return [a is b, c is a, sorted(store.runs)]


def _rule_stale_run_id(store):
    store.get_or_create("x", 3, 2, 2)
    return [store.get_or_create("x", 2, 2, 2) is None, store.get_or_create("x", 3, 2, 2) is None,
            sorted(store.runs)]


def _rule_max_run_bound(store):
    store._max_run_cap = 3
    for i in range(5):
        store.get_or_create(f"id{i}", 5, 1, 1)
    store.get_or_create("id1", 6, 1, 1)  # re-inserted at the newest position
    # an evicted id forgets its epoch: a stale run_id is accepted again
    return [list(store._max_run.items()), store.get_or_create("id0", 1, 1, 1) is None]


def _rule_was_served_once(store):
    r = store.get_or_create("x", 1, 2, 2)
    r.local_ids = [0, 1]
    before = store.was_served_once("x", 1, 0)
    _served(store, r, [0, 1])
    return [before, store.was_served("x", 1), store.was_served_once("x", 1, 0),
            store.was_served_once("x", 1, 0), store.was_served_once("x", 1, 1),
            store.get_or_create("x", 1, 2, 2) is None]


def _rule_forget_idle(store):
    old = store.get_or_create("x", 1, 1, 1)
    store.get_or_create("y", 1, 1, 1)
    old.last_activity -= 100.0
    fresh = store.get_or_create("z", 4, 1, 1)
    store.forget("x", only_idle_for=50.0)
    store.forget("z", only_idle_for=50.0)  # touched just now: stays
    kept = sorted(store.runs)
    store.forget("z", run_id=3)  # only epochs <= 3
    kept2 = sorted(store.runs)
    store.forget("z")
    return [kept, kept2, sorted(store.runs), fresh.id]


def _rule_mark_served_drops_inputs(store):
    r = store.get_or_create("x", 1, 3, 3)
    r.register(0, np.zeros(2, np.int32), np.zeros((2, 1), np.float32))
    r.local_ids = [0, 1, 2]
    store.mark_served(r, 0)
    after_one = [len(r.parts), ("x", 1) in store.runs]
    _served(store, r, [1, 2])
    return [after_one, ("x", 1) in store.runs, list(store.done)]


def _rule_done_ring_is_bounded(store):
    store.done = type(store.done)(maxlen=2)
    for i in range(3):
        r = store.get_or_create(f"s{i}", 1, 1, 1)
        store.mark_served(r, 0)
    return [list(store.done), store.was_served("s0", 1), store.was_served("s2", 1)]


RULES = {name[len("_rule_"):]: fn for name, fn in globals().items() if name.startswith("_rule_")}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_store_rule_equals_reference(rule):
    want_store, got_store = _both()
    assert RULES[rule](got_store) == RULES[rule](want_store)


# ---------------------------------------------------------- LocalCluster


def make_part(i, n):
    """(keys, values) of partition i as CPU tensors (shard i's device)."""
    rng = np.random.default_rng(i)
    keys = rng.integers(0, 1 << 30, n).astype(np.int32)
    values = np.stack([keys.astype(np.float32), np.full(n, i, np.float32)], 1)
    return torch.from_numpy(keys), torch.from_numpy(values)


async def _cluster(install=N_DEV):
    cluster = LocalCluster(n_workers=N_DEV, scheduler_kwargs={"validate": True},
                           worker_kwargs={"validate": True})
    await cluster._start()
    for w in cluster.workers[:install]:
        device.install_device_shuffle(w, reschedule=Reschedule, devices=CPU8)
    return cluster


def _uninstall(cluster):
    for w in cluster.workers:
        device.uninstall_device_shuffle(w)


@gen_test(timeout=150)
async def test_p2p_shuffle_device_on_a_local_cluster():
    cluster = await _cluster()
    try:
        async with Client(cluster.scheduler_address) as c:
            n_rows = 300
            inputs = [c.submit(make_part, i, n_rows, key=f"tpart-{i}") for i in range(N_DEV)]
            await c.gather(inputs)
            outs = await device.p2p_shuffle_device(c, inputs)
            await asyncio.wait_for(wait_futures(outs), 90)
            results = await c.gather(outs)
            sid = outs[0].key.rsplit("-unpack-", 1)[0]
            # the store released the run once every output was served
            assert not any(k[0] == sid for k in device.device_store().runs)
            assert device.device_store().was_served(sid, 1)
    finally:
        _uninstall(cluster)
        await cluster.close()
    all_keys = torch.cat([make_part(i, n_rows)[0] for i in range(N_DEV)])
    dest = ici._mix32(all_keys) % N_DEV
    total = 0
    for d, (ko, vo) in enumerate(results):
        assert sorted(ko.tolist()) == sorted(all_keys[dest == d].tolist()), f"device {d}"
        np.testing.assert_array_equal(vo[:, 0].numpy(), ko.numpy().astype(np.float32))
        total += len(ko)
    assert total == N_DEV * n_rows


@gen_test(timeout=150)
async def test_transfers_and_barrier_are_restricted_to_installed_workers():
    cluster = await _cluster()
    try:
        async with Client(cluster.scheduler_address) as c:
            inputs = [c.submit(make_part, i, 20, key=f"rpart-{i}") for i in range(N_DEV)]
            outs = await device.p2p_shuffle_device(c, inputs)
            await asyncio.wait_for(wait_futures(outs), 90)
            sid = outs[0].key.rsplit("-unpack-", 1)[0]
            tasks = cluster.scheduler.state.tasks
            installed = {w.address for w in cluster.workers}
            for key in [f"{sid}-transfer-{i}" for i in range(N_DEV)] + [f"{sid}-barrier"]:
                if key in tasks:  # released once its dependents finished
                    assert tasks[key].worker_restrictions == installed, key
            owners = {tasks[o.key].worker_restrictions.pop() for o in outs}
            assert owners <= installed
    finally:
        _uninstall(cluster)
        await cluster.close()


@gen_test(timeout=150)
async def test_p2p_shuffle_device_refuses_an_output_owner_not_installed():
    cluster = await _cluster(install=N_DEV - 1)
    try:
        async with Client(cluster.scheduler_address) as c:
            inputs = [c.submit(make_part, i, 8, key=f"npart-{i}") for i in range(N_DEV)]
            with pytest.raises(RuntimeError, match="install_device_shuffle"):
                await device.p2p_shuffle_device(c, inputs)
    finally:
        _uninstall(cluster)
        await cluster.close()


def test_body_without_an_installed_worker_raises(monkeypatch):
    monkeypatch.setattr(device, "_installed", {})
    with pytest.raises(RuntimeError, match="install_device_shuffle"):
        asyncio.run(device.device_shuffle_transfer((torch.zeros(1), torch.zeros(1, 1)), "s", 0))
