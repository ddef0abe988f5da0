"""The port's device shuffle (``distributed_tpu_torch/shuffle/device.py``)
against the reference's (``distributed_tpu/shuffle/device.py``), on the
CPU: the port's runs on 8 CPU shards, the reference's on the conftest's 8
virtual XLA CPU devices.

Tolerance: none.  ``DeviceRun`` outputs on ragged partitions equal the
reference's bit for bit; each rule of ``DeviceShuffleStore`` gives the
same answers to the same calls on both stores; ``p2p_shuffle_device`` on
the port's own ``LocalCluster(device="cpu")`` gives the outputs the
reference's gives on its cluster, bit for bit, every row on ``mix32(key)
% 8``; its task bodies find their worker through ``get_worker()`` as the
reference's do (a body outside a worker raises the same error), and a
stale-epoch unpack reschedules once, then restarts the epoch, as in the
reference.

The divergence: the store's ``devices`` is the one place that sets the
mesh's devices (``["cpu"] * 8`` here, ``["cuda:0"] * 8`` on one card),
and its default, the visible CUDA devices, raises without a card
(``test_the_stores_devices_set_the_mesh``).
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest
import torch

from distributed_tpu.exceptions import Reschedule as RefReschedule
from distributed_tpu.shuffle import device as ref_device
from distributed_tpu.worker import context as ref_context
from distributed_tpu_torch.exceptions import Reschedule
from distributed_tpu_torch.ops import ici
from distributed_tpu_torch.shuffle import device
from distributed_tpu_torch.worker import context

from conftest import gen_test
from torch_shuffle_cases import PORT, REF, cluster_and_client

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


def make_ref_part(i, n):
    """The same partition as jax arrays on the reference's mesh device i."""
    import jax
    import jax.numpy as jnp

    keys, values = make_part(i, n)
    dev = jax.devices()[i]
    return jax.device_put(jnp.asarray(keys.numpy()), dev), jax.device_put(jnp.asarray(values.numpy()), dev)


@pytest.fixture
def cpu_store():
    """The process store's mesh on 8 CPU shards, put back afterwards (the
    store is process-wide and tier-1 runs many files a process)."""
    store = device.device_store()
    old = store.devices
    store.devices = CPU8
    yield store
    store.devices = old


async def _device_shuffle(pkg, n_rows, tag):
    """A device shuffle of 8 seeded partitions on ``pkg``'s cluster of 8
    workers; returns the outputs as numpy, the store's epoch record and
    the task keys the scheduler holds."""
    mod, maker = (device, make_part) if pkg is PORT else (ref_device, make_ref_part)
    async with cluster_and_client(pkg, N_DEV) as (cluster, c):
        inputs = [c.submit(maker, i, n_rows, key=f"{tag}-{i}") for i in range(N_DEV)]
        await c.gather(inputs)
        outs = await mod.p2p_shuffle_device(c, inputs)
        results = await asyncio.wait_for(c.gather(outs), 90)
        sid = outs[0].key.rsplit("-unpack-", 1)[0]
        st = cluster.scheduler.extensions["shuffle"].active[sid]
        served = (not any(k[0] == sid for k in mod.device_store().runs),
                  mod.device_store().was_served(sid, st.run_id))
        restrictions = [sorted(cluster.scheduler.state.tasks[o.key].worker_restrictions)
                        == [st.worker_for[j]] for j, o in enumerate(outs)]
        return [(np.asarray(k), np.asarray(v)) for k, v in results], served, restrictions, results


@gen_test(timeout=150)
async def test_p2p_shuffle_device_on_a_local_cluster(cpu_store):
    """The port's ``p2p_shuffle_device`` on its own ``LocalCluster``: every
    row on ``mix32(key) % 8``, values riding along, the run collected once
    every output was served."""
    n_rows = 300
    got, served, restricted, _ = await _device_shuffle(PORT, n_rows, "lpart")
    assert served == (True, True) and all(restricted)
    all_keys = torch.cat([make_part(i, n_rows)[0] for i in range(N_DEV)])
    dest = ici._mix32(all_keys) % N_DEV
    for d, (ko, vo) in enumerate(got):
        assert sorted(ko.tolist()) == sorted(all_keys[dest == d].tolist()), f"device {d}"
        np.testing.assert_array_equal(vo[:, 0], ko.astype(np.float32))
    assert sum(len(k) for k, _ in got) == N_DEV * n_rows


@gen_test(timeout=150)
async def test_p2p_shuffle_device_on_the_ports_cluster_equals_reference(cpu_store):
    """``p2p_shuffle_device`` on the port's own ``LocalCluster(device="cpu")``
    gives the reference cluster's outputs bit for bit: output ``d`` holds
    every row with ``mix32(key) % 8 == d``, sources in order, values riding
    along; the store collects the served epoch; unpack ``d`` is restricted
    to its owner."""
    n_rows = 300
    want, want_served, want_restricted, _ = await _device_shuffle(REF, n_rows, "rpart")
    got, served, restricted, tensors = await _device_shuffle(PORT, n_rows, "tpart")
    assert served == want_served == (True, True)
    assert restricted == want_restricted and all(restricted)
    all_keys = torch.cat([make_part(i, n_rows)[0] for i in range(N_DEV)])
    dest = ici._mix32(all_keys) % N_DEV
    for d in range(N_DEV):
        (gk, gv), (wk, wv) = got[d], want[d]
        assert tensors[d][0].dtype == torch.int32 and tensors[d][0].device.type == "cpu"
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(gv.view(np.uint8), wv.view(np.uint8))
        assert sorted(gk.tolist()) == sorted(all_keys[dest == d].tolist()), f"device {d}"
        np.testing.assert_array_equal(gv[:, 0], gk.astype(np.float32))
    assert sum(len(k) for k, _ in got) == N_DEV * n_rows


def test_the_stores_devices_set_the_mesh(cpu_store):
    """The store's ``devices`` builds every new run's mesh; its default
    (None: the visible CUDA devices) raises where there is no card, and
    nothing drops to the CPU."""
    parts = _parts([3] * N_DEV, seed=2)
    run = cpu_store.get_or_create("mesh-devices", 1, N_DEV, N_DEV)
    assert run.devices == CPU8
    for i, (k, v) in enumerate(parts):
        run.register(i, torch.from_numpy(k), torch.from_numpy(v))
    run.exchange()
    assert all(run.outputs[d][0].device.type == "cpu" for d in range(N_DEV))
    cpu_store.forget("mesh-devices")
    bare = device.DeviceRun("mesh-devices", 2, N_DEV, N_DEV)
    for i, (k, v) in enumerate(parts):
        bare.register(i, torch.from_numpy(k), torch.from_numpy(v))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bare.exchange()
        assert bare.outputs is None


def _in_no_worker(mod, call):
    try:
        asyncio.run(call(mod))
    except Exception as exc:  # noqa: BLE001 - the two packages' errors are compared
        return type(exc).__name__, str(exc)
    return None


def test_a_body_outside_a_worker_raises_as_the_reference():
    """A task body run outside a worker raises ``get_worker()``'s error,
    the same type and text as the reference's."""
    calls = [
        lambda m: m.device_shuffle_transfer((np.zeros(1, np.int32), np.zeros((1, 1))), "s", 0),
        lambda m: m.device_shuffle_barrier("s", (0, 1)),
        lambda m: m.device_shuffle_unpack("s", 0, 1),
    ]
    for call in calls:
        got, want = _in_no_worker(device, call), _in_no_worker(ref_device, call)
        assert got == want == ("ValueError", "no worker found in this thread/task context")


async def _stale_unpack(pkg, tag):
    """Finish a device shuffle, then run unpack 0's body twice more inside
    a worker's context under the served epoch: what each raises and the
    epoch after it."""
    mod, ctx, resched = ((device, context, Reschedule) if pkg is PORT
                         else (ref_device, ref_context, RefReschedule))
    maker = make_part if pkg is PORT else make_ref_part
    async with cluster_and_client(pkg, N_DEV) as (cluster, c):
        inputs = [c.submit(maker, i, 40, key=f"{tag}-{i}") for i in range(N_DEV)]
        outs = await mod.p2p_shuffle_device(c, inputs)
        await asyncio.wait_for(c.gather(outs), 90)
        ext = cluster.scheduler.extensions["shuffle"]
        sid = outs[0].key.rsplit("-unpack-", 1)[0]
        st = ext.active[sid]
        run_id = st.run_id
        worker = cluster.workers[0]
        seen = []
        for _ in range(2):
            token = ctx.set_async_worker(worker, key=outs[0].key)
            try:
                await mod.device_shuffle_unpack(sid, 0, run_id)
                seen.append("returned")
            except resched as exc:
                seen.append(str(exc).replace(sid, "<id>"))
            finally:
                ctx.reset_async_worker(token)
            await asyncio.sleep(ext.restart_debounce * 4 + 0.05)
            seen.append(st.run_id - run_id)
        return seen


@gen_test(timeout=150)
async def test_a_stale_epoch_unpack_reschedules_once_then_restarts(cpu_store):
    """An unpack of an epoch already served and collected reschedules once
    without a restart; a second miss of the same partition restarts the
    epoch -- the reference's answers, in order."""
    want = await _stale_unpack(REF, "rstale")
    got = await _stale_unpack(PORT, "tstale")
    assert got == want
    assert got[0] == "shuffle <id> run 1 already served" and got[1] == 0
    assert got[2] == "shuffle <id> run 1 closed" and got[3] == 1
