"""The port's P2P shuffle (``distributed_tpu_torch/shuffle/columnar.py``,
``core.py``, ``scheduler_ext.py``, ``api.py``) against the reference's, on
the CPU: the cases of ``tests/test_shuffle.py`` run on both packages with
the same numpy-seeded inputs.

Tolerance: none.  ``hash_column``, the splitters, ``concat_arrays`` and
``join_arrays`` give bit-identical arrays; every live scenario's outputs
(records, keyed records, columnar arrays, a rechunk, a columnar join) on
the port's ``LocalCluster(device="cpu")`` equal the reference cluster's bit
for bit, partition by partition; the restart protocol (epoch fencing,
coalesced restarts, shutdown, the restart budget) gives the reference's
outcomes; and a shuffle task pinned home is never stolen.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest
import torch

from distributed_tpu.shuffle import columnar as ref_columnar
from distributed_tpu.shuffle import core as ref_core
from distributed_tpu_torch.shuffle import columnar, core

from conftest import gen_test
from torch_shuffle_cases import (
    PACKAGES,
    arrays_bytes,
    cluster_and_client,
    first,
    keyed_partition,
    left_columns,
    make_chunk,
    make_columns,
    make_partition,
    new_cluster,
    right_columns,
    slow_partition,
)

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)


# ------------------------------------------------------------ the columnar path


COLUMNS = {
    "int64": lambda rng: rng.integers(-(1 << 62), 1 << 62, 4000),
    "int32": lambda rng: rng.integers(-(1 << 31), 1 << 31, 4000).astype(np.int32),
    "uint16": lambda rng: rng.integers(0, 1 << 16, 4000).astype(np.uint16),
    "bool": lambda rng: rng.random(4000) < 0.5,
    "float64": lambda rng: np.concatenate([rng.standard_normal(3997), [0.0, -0.0, np.inf]]),
    "float32": lambda rng: rng.standard_normal(4000).astype(np.float32),
    "str": lambda rng: np.asarray([f"k{int(x)}" for x in rng.integers(0, 300, 400)]),
}


@pytest.mark.parametrize("kind", sorted(COLUMNS))
def test_hash_column_equals_reference(kind):
    """``hash_column`` is bit-identical to the reference's on every dtype
    (splitmix64 on the bits; strings through ``stable_hash``)."""
    col = COLUMNS[kind](np.random.default_rng(len(kind)))
    got, want = columnar.hash_column(col), ref_columnar.hash_column(col)
    assert got.dtype == want.dtype == np.uint64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("npartitions", [1, 7, 128])
@pytest.mark.parametrize("kind", ["int64", "float64", "str"])
def test_split_and_concat_equal_reference(kind, npartitions):
    """``split_arrays_by_hash`` routes every row to the reference's output,
    in the reference's order, and ``concat_arrays`` puts them back bit for
    bit."""
    rng = np.random.default_rng(npartitions)
    key = COLUMNS[kind](rng)
    part = {"key": key, "x": rng.random(len(key)), "i": np.arange(len(key))}
    got = columnar.split_arrays_by_hash(part, npartitions, on="key")
    want = ref_columnar.split_arrays_by_hash(part, npartitions, on="key")
    assert sorted(got) == sorted(want)
    for j in want:
        assert arrays_bytes(got[j]) == arrays_bytes(want[j])
    shards = [s for _, s in sorted(got.items())]
    assert arrays_bytes(columnar.concat_arrays(shards)) == \
        arrays_bytes(ref_columnar.concat_arrays(shards))
    assert columnar.concat_arrays([]) == ref_columnar.concat_arrays([]) == {}


@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
def test_join_arrays_equals_reference(how):
    """``join_arrays`` gives the reference's rows in the reference's order,
    bit for bit (duplicate keys, misses on either side, NaN fillers)."""
    rng = np.random.default_rng(3)
    left = {"key": rng.integers(0, 60, 300), "v": rng.random(300), "w": np.arange(300)}
    right = {"key": rng.integers(30, 90, 200), "v": rng.random(200)}
    got = columnar.join_arrays(left, right, "key", how)
    want = ref_columnar.join_arrays(left, right, "key", how)
    assert arrays_bytes(got) == arrays_bytes(want)
    for lhs, rhs in (({}, right), (left, {}), ({}, {})):
        assert arrays_bytes(columnar.join_arrays(lhs, rhs, "key", how)) == \
            arrays_bytes(ref_columnar.join_arrays(lhs, rhs, "key", how))
    with pytest.raises(ValueError):
        columnar.join_arrays(left, right, "key", "cross")


def test_record_splitters_and_stable_hash_equal_reference():
    """``stable_hash``, ``split_records_by_hash``, a keyed splitter and
    ``concat_records`` give the reference's values and partitions."""
    values = [0, 7, -3, 2**70, True, False, "a", "zz", b"bytes", 1.5, (1, "x"), None]
    assert [core.stable_hash(v) for v in values] == [ref_core.stable_hash(v) for v in values]
    recs = make_partition(4, 300) + ["s", "t", (1, 2)]
    assert core.split_records_by_hash(recs, 9) == ref_core.split_records_by_hash(recs, 9)
    keyed = [keyed_partition(i) for i in range(3)]
    flat = [r for p in keyed for r in p]
    assert core.make_keyed_splitter(first)(flat, 4) == ref_core.make_keyed_splitter(first)(flat, 4)
    assert core.concat_records(keyed) == ref_core.concat_records(keyed)


def test_shuffle_spec_messages_equal_reference():
    """A spec's message and its round trip are the reference's."""
    args = ("s", 3, 4, {0: "a", 1: "b", 2: "a", 3: "c"})
    for kw in ({}, {"n_inputs": 9, "device_owned": True}):
        got, want = core.ShuffleSpec(*args, **kw), ref_core.ShuffleSpec(*args, **kw)
        assert got.to_msg() == want.to_msg()
        assert got.participants == want.participants == ["a", "b", "c"]
        back = core.ShuffleSpec.from_msg(want.to_msg())
        assert back.to_msg() == want.to_msg() and back.worker_for == want.worker_for


# -------------------------------------------------------------- live scenarios


async def records_shuffle(pkg, c, cluster):
    inputs = [c.submit(make_partition, i, key=f"input-{i}") for i in range(4)]
    await c.gather(inputs)
    outs = await pkg.shuffle.p2p_shuffle(c, inputs, npartitions_out=5)
    results = await asyncio.wait_for(c.gather(outs), 60)
    for j, part in enumerate(results):
        assert all(x % 5 == j for x in part)
    return results


async def keyed_shuffle(pkg, c, cluster):
    inputs = [c.submit(keyed_partition, i, key=f"kin-{i}") for i in range(3)]
    await c.gather(inputs)
    outs = await pkg.shuffle.p2p_shuffle(c, inputs, npartitions_out=4, key=first)
    return await asyncio.wait_for(c.gather(outs), 60)


async def columnar_shuffle(pkg, c, cluster):
    parts = c.map(make_columns, range(6))
    await c.gather(parts)
    outs = await pkg.shuffle.p2p_shuffle_arrays(c, parts, npartitions_out=4, on="key")
    results = await asyncio.wait_for(c.gather(outs), 60)
    assert sum(len(p["key"]) for p in results) == 6 * 5000
    return [arrays_bytes(p) for p in results]


async def rechunk(pkg, c, cluster):
    sizes, offsets = [30, 30, 40], [0, 30, 60]
    chunks = [c.submit(make_chunk, offsets[i], sizes[i], key=f"ch-{i}") for i in range(3)]
    await c.gather(chunks)
    outs = await pkg.shuffle.p2p_rechunk(c, chunks, sizes, [25, 25, 25, 25])
    results = await asyncio.wait_for(c.gather(outs), 60)
    np.testing.assert_array_equal(np.concatenate(results), np.arange(100))
    return [(str(r.dtype), r.tobytes()) for r in results]


async def columnar_merge(pkg, c, cluster):
    lf = c.map(left_columns, range(4))
    rf = c.map(right_columns, range(4))
    await c.gather(lf + rf)
    outs = await pkg.shuffle.p2p_merge_arrays(c, lf, rf, on="key", how="inner")
    return [arrays_bytes(p) for p in await asyncio.wait_for(c.gather(outs), 60)]


async def outputs_on_their_owners(pkg, c, cluster):
    inputs = [c.submit(make_partition, i, key=f"wi-{i}") for i in range(2)]
    await c.gather(inputs)
    outs = await pkg.shuffle.p2p_shuffle(c, inputs, npartitions_out=4)
    results = await asyncio.wait_for(c.gather(outs), 60)
    ext = cluster.scheduler.extensions["shuffle"]
    st = ext.active[outs[0].key.rsplit("-unpack-", 1)[0]]
    who = await c.who_has(outs)
    # unpack j sits on worker_for[j], round-robin over the sorted workers
    addrs = sorted(w.address for w in cluster.workers)
    assert all(who[o.key] == [st.worker_for[j]] for j, o in enumerate(outs))
    return results, [addrs.index(st.worker_for[j]) for j in range(4)]


SCENARIOS = {"records": (records_shuffle, 3), "keyed": (keyed_shuffle, 2),
             "columnar": (columnar_shuffle, 3), "rechunk": (rechunk, 2),
             "columnar_merge": (columnar_merge, 3), "owners": (outputs_on_their_owners, 2)}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@gen_test(timeout=120)
async def test_live_shuffle_equals_reference(scenario):
    """Each graph builder's outputs on the port's cluster equal the
    reference cluster's bit for bit, partition by partition."""
    fn, n_workers = SCENARIOS[scenario]
    out = {}
    for pkg in PACKAGES:
        async with cluster_and_client(pkg, n_workers) as (cluster, c):
            out[pkg.name] = await fn(pkg, c, cluster)
    assert out["port"] == out["reference"]


@gen_test(timeout=120)
async def test_run_id_fencing_equals_reference():
    """A newer epoch closes the older run; a push of the older epoch is
    refused as stale and the newer one stored, as in the reference."""
    out = {}
    for pkg in PACKAGES:
        async with await new_cluster(pkg, 1) as cluster:
            worker = cluster.workers[0]
            owners = {0: worker.address, 1: worker.address}
            spec1, spec2 = pkg.core.ShuffleSpec("sx", 1, 2, owners), pkg.core.ShuffleSpec("sx", 2, 2, owners)
            ext = worker.shuffle
            run1 = ext.get_or_create(spec1)
            run2 = ext.get_or_create(spec2)
            stale = await ext.shuffle_receive(id="sx", run_id=1, spec=spec1.to_msg(),
                                              shards={0: [(0, [1, 2])]})
            fresh = await ext.shuffle_receive(id="sx", run_id=2, spec=spec2.to_msg(),
                                              shards={0: [(0, [3])]})
            flushed = await ext.shuffle_receive_flush(id="sx", run_id=1)
            out[pkg.name] = (run1.closed, stale["status"], fresh["status"], flushed["status"],
                             await run2.store.read(0))
    assert out["port"] == out["reference"] == (True, "stale", "OK", "stale", [(0, [3])])


@gen_test(timeout=120)
async def test_transfer_only_worker_is_flushed_before_unpack():
    """A worker that runs transfers but owns no output has its shards in
    flight past the barrier: the barrier flushes every participant, so no
    row is lost, and the outputs equal the reference's."""
    out = {}
    for pkg in PACKAGES:
        Run = pkg.core.ShuffleRun
        orig = Run._send_to_peer

        async def slow_send(self, addr, shards, orig=orig):
            await asyncio.sleep(0.3)  # keep shards in flight past the barrier
            await orig(self, addr, shards)

        Run._send_to_peer = slow_send
        try:
            async with cluster_and_client(pkg, 3) as (cluster, c):
                transfer_only = sorted(cluster.scheduler.state.workers)[2]
                inputs = [c.submit(make_partition, i, key=f"tfo-{i}", workers=[transfer_only])
                          for i in range(4)]
                await c.gather(inputs)
                outs = await pkg.shuffle.p2p_shuffle(c, inputs, npartitions_out=2)
                results = await asyncio.wait_for(c.gather(outs), 60)
                st = next(iter(cluster.scheduler.extensions["shuffle"].active.values()))
                assert transfer_only in st.participants
                out[pkg.name] = results
        finally:
            Run._send_to_peer = orig
    assert sorted(x for p in out["port"] for x in p) == sorted(
        x for i in range(4) for x in make_partition(i))
    assert out["port"] == out["reference"]


# ------------------------------------------------------------ the restart protocol


@gen_test(timeout=60)
async def test_worker_losses_coalesce_into_one_restart():
    """Three participants leaving inside the debounce window bump the epoch
    once, and the survivors own every output, as in the reference."""
    out = {}
    for pkg in PACKAGES:
        async with await new_cluster(pkg, 4) as cluster:
            sched = cluster.scheduler
            ext = sched.extensions["shuffle"]
            resp = await ext.handle_get_or_create(id="s-coalesce", npartitions_out=8, n_inputs=4)
            st = ext.active["s-coalesce"]
            victims = sorted(set(st.worker_for.values()))[:3]
            for addr in victims:
                await sched.remove_worker(addr, reason="test-scale-down")
            await asyncio.sleep(ext.restart_debounce * 6 + 0.05)
            out[pkg.name] = (resp["status"], st.run_id, len(victims),
                             bool(set(st.worker_for.values()) & set(victims)))
    assert out["port"] == out["reference"] == ("OK", 2, 3, False)


@gen_test(timeout=60)
async def test_scheduler_close_aborts_without_restart():
    """Workers leaving while the cluster closes start no epoch."""
    out = {}
    for pkg in PACKAGES:
        async with await new_cluster(pkg, 3) as cluster:
            ext = cluster.scheduler.extensions["shuffle"]
            await ext.handle_get_or_create(id="s-closing", npartitions_out=4, n_inputs=2)
            st = ext.active["s-closing"]
        out[pkg.name] = (ext.active, ext._pending_restarts, st.run_id)
    assert out["port"] == out["reference"] == ({}, {}, 1)


@gen_test(timeout=90)
async def test_restart_budget_errs_the_outputs_as_the_reference():
    """Past ``shuffle.max-restarts`` the shuffle is dropped and its outputs
    err with ``P2PShuffleError`` and the reference's message."""
    out = {}
    for pkg in PACKAGES:
        with pkg.config.set({"shuffle.max-restarts": 2, "shuffle.restart-debounce": "10ms"}):
            async with cluster_and_client(pkg, 2) as (cluster, c):
                ext = cluster.scheduler.extensions["shuffle"]
                # inputs never finish, so the pipeline waits while the budget runs out
                inputs = [c.submit(slow_partition, i, key=f"slowin-{i}") for i in range(2)]
                outs = await pkg.shuffle.p2p_shuffle(c, inputs, npartitions_out=2)
                sid = outs[0].key.rsplit("-unpack-", 1)[0]
                st = ext.active[sid]
                for _ in range(4):
                    await ext.handle_restart(id=sid, run_id=st.run_id)
                    await asyncio.sleep(0.2)
                    if sid not in ext.active:
                        break
                with pytest.raises(pkg.exceptions.P2PShuffleError) as info:
                    await asyncio.wait_for(c.gather(outs), 30)
                message = str(info.value).replace(sid, "<id>")
                out[pkg.name] = (sid in ext.active, st.run_id, message)
    assert out["port"] == out["reference"]
    assert out["port"][0] is False and "failed after 2 restarts" in out["port"][2]


@gen_test(timeout=90)
async def test_restart_budget_with_transfers_in_memory_equals_reference():
    """A barrier that keeps failing while the transfers sit in memory ends
    in ``P2PShuffleError`` with the shuffle dropped, not resurrected."""
    out = {}
    for pkg in PACKAGES:
        with pkg.config.set({"shuffle.max-restarts": 1, "shuffle.restart-debounce": "10ms"}):
            async with cluster_and_client(pkg, 2) as (cluster, c):
                sched = cluster.scheduler

                async def failing_barrier(**kwargs):
                    return {"status": "barrier-failed", "error": "induced"}

                sched.handlers["shuffle_barrier"] = failing_barrier
                inputs = [c.submit(make_partition, i, key=f"bin-{i}") for i in range(2)]
                await c.gather(inputs)
                outs = await pkg.shuffle.p2p_shuffle(c, inputs, npartitions_out=2)
                with pytest.raises(pkg.exceptions.P2PShuffleError) as info:
                    await asyncio.wait_for(c.gather(outs), 60)
                sid = outs[0].key.rsplit("-unpack-", 1)[0]
                out[pkg.name] = (sid in sched.extensions["shuffle"].active,
                                 str(info.value).replace(sid, "<id>"))
    assert out["port"] == out["reference"]
    assert out["port"][0] is False


# ------------------------------------------------------------ stealing


@gen_test(timeout=90)
async def test_restricted_unpack_tasks_are_never_stolen():
    """Each unpack task is restricted to its output's owner.  While the
    unpacks run, neither a balance cycle nor a device steal plan naming
    another worker for every one of them moves any, and every output ends
    on its owner -- on the port as on the reference, whose stealable sets
    and pins the port's equal."""
    out = {}
    for pkg in PACKAGES:
        Run = pkg.core.ShuffleRun
        orig = Run.get_output_partition
        gate = asyncio.Event()
        entered: list[int] = []

        async def held(self, j, assembler, timeout=30.0, orig=orig, gate=gate, entered=entered):
            entered.append(j)
            await gate.wait()
            return await orig(self, j, assembler, timeout)

        Run.get_output_partition = held
        try:
            # two unpacks a worker, each held in its slot until all six
            # entered: two threads a worker.  With one, the second waited
            # for the execute pipeline, which takes it only while the
            # "shuffle" prefix's measured mean (its transfers and barrier)
            # is under 5 ms, so under load the test hung to its timeout
            async with cluster_and_client(pkg, 3, threads_per_worker=2) as (cluster, c):
                inputs = [c.submit(make_partition, i, key=f"pin-{i}") for i in range(3)]
                await c.gather(inputs)
                outs = await pkg.shuffle.p2p_shuffle(c, inputs, npartitions_out=6)
                while len(entered) < 6:
                    await asyncio.sleep(0.01)
                state = cluster.scheduler.state
                stealing = cluster.scheduler.extensions["stealing"]
                ext = cluster.scheduler.extensions["shuffle"]
                st = ext.active[outs[0].key.rsplit("-unpack-", 1)[0]]
                unpacks = [state.tasks[o.key] for o in outs]
                homes = [ts.processing_on.address for ts in unpacks]
                restrictions = [sorted(ts.worker_restrictions) for ts in unpacks]
                for ts in unpacks:
                    stealing.put_key_in_stealable(ts)
                pins = ([ts.homed for ts in unpacks],
                        [ts.key in stealing.key_stealable for ts in unpacks])
                stealing.balance()
                ws_of = sorted(state.running, key=lambda ws: ws.address)
                # a plan naming, for each unpack, a thief that is not its home
                thieves = [next(i for i, ws in enumerate(ws_of) if ws is not ts.processing_on)
                           for ts in unpacks]
                stealing._apply_device_plan(thieves, unpacks, ws_of)
                moved = [ts.key in stealing.in_flight for ts in unpacks]
                gate.set()
                results = await asyncio.wait_for(c.gather(outs), 60)
                who = await c.who_has(outs)
                owners = [st.worker_for[j] for j in range(6)]
                out[pkg.name] = (homes == owners, restrictions == [[a] for a in owners], pins,
                                 moved, [who[o.key] == [a] for o, a in zip(outs, owners)], results)
        finally:
            Run.get_output_partition = orig
    assert out["port"] == out["reference"]
    at_home, restricted, _pins, moved, on_owner, _ = out["port"]
    assert at_home and restricted and not any(moved) and all(on_owner)
