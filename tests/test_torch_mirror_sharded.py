"""The mirror's workers-axis view (K11, ``TorchMirror.sharded_device_view``)
and ``TorchPlacement``'s mesh branch, against the reference's
``SchedulerMirror.sharded_device_view`` and ``JaxPlacement`` on the
conftest's 8 virtual XLA CPU devices.

Tolerances: none.  The view's rows equal the host rows bit for bit; the
per-shard counters equal the reference's, except ``bytes_uploaded``, where
the port counts the exact payload (dirty rows times the field widths) and
the reference the power-of-two-padded scatter (at least 512 rows a
shard), which each test states.  The sharded engine fed by the view
places as it does fed by host arrays, and the mesh plan path's hints
equal ``JaxPlacement``'s on every layout (the engine equals the
reference's bit for bit, ``test_torch_sharded.py``).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from distributed_tpu import config
from distributed_tpu.graph.spec import TaskSpec
from distributed_tpu.ops import partition as ref_partition
from distributed_tpu.scheduler.jax_placement import JaxPlacement
from distributed_tpu.scheduler.state import SchedulerState
from distributed_tpu_torch.ops import leveled, sharded
from distributed_tpu_torch.ops.partition import make_engine_mesh
from distributed_tpu_torch.scheduler.mirror import SHARDED_FIELDS, TorchMirror
from distributed_tpu_torch.scheduler.torch_placement import TorchPlacement

from test_leveled import BW, random_dag

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)

FIELD_BYTES = sum(np.dtype(d).itemsize for d in (np.int32, np.float32, np.bool_))  # 9 a row


def cpu_mesh(layout: str):
    dt, dw = (int(p) for p in layout.split("x"))
    return make_engine_mesh(layout=layout, devices=["cpu"] * (dt * dw))


def _state(n_workers: int, name: str = "ms", adopt: bool = True) -> SchedulerState:
    state = SchedulerState()
    if adopt:
        TorchMirror.adopt(state, device="cpu")
    for i in range(n_workers):
        state.add_worker_state(f"tcp://{name}:{i}", nthreads=2, memory_limit=2**30, name=f"w{i}")
    return state


def _rows_equal_host(mirror, view) -> bool:
    return all(
        np.array_equal(torch.cat(view[f]).numpy(), getattr(mirror, f)) for f in SHARDED_FIELDS
    )


def _churn(state, rng, step: int) -> None:
    """The same add/remove/mark sequence on any state."""
    addrs = sorted(state.workers)
    if step % 3 == 0:
        state.add_worker_state(f"tcp://new:{step}", nthreads=1 + step % 4, memory_limit=2**30)
    elif step % 3 == 1 and len(addrs) > 4:
        state.remove_worker_state(addrs[int(rng.integers(len(addrs)))], stimulus_id="t", safe=True)
    for addr in rng.choice(sorted(state.workers), 3, replace=False):
        ws = state.workers[addr]
        state._adjust_occupancy(ws, float(rng.uniform(0.1, 2.0)))


def test_view_blocks_equal_host_rows_and_sit_per_shard():
    state = _state(12)
    m = state.mirror
    view = m.sharded_device_view(cpu_mesh("4x2"))
    assert set(view) == set(SHARDED_FIELDS)
    assert all(len(view[f]) == 2 and len(view[f][0]) == m.cap // 2 for f in SHARDED_FIELDS)
    assert _rows_equal_host(m, view)
    assert m.sharded_stats() == {"n_shards": 2, "rows_uploaded": [0, 0],
                                 "bytes_uploaded": [0, 0], "full_packs": [1, 1]}


def test_fresh_cycle_uploads_nothing_and_dirty_rows_go_to_their_shard():
    state = _state(16)
    m = state.mirror
    mesh = cpu_mesh("4x2")
    m.sharded_device_view(mesh)
    m.sharded_device_view(mesh)
    assert m.sharded_stats()["rows_uploaded"] == [0, 0]
    ws = [w for w in state.workers.values() if w.idx in (1, 2, 13)]
    for w in ws:
        state._adjust_occupancy(w, 1.5)
    view = m.sharded_device_view(mesh)
    ss = m.sharded_stats()
    assert ss["rows_uploaded"] == [2, 1]
    assert ss["bytes_uploaded"] == [2 * FIELD_BYTES, FIELD_BYTES]  # exact payload
    assert ss["full_packs"] == [1, 1]
    assert _rows_equal_host(m, view)
    # an equal mesh built again re-packs nothing (equality, not identity)
    m.sharded_device_view(cpu_mesh("4x2"))
    assert m.sharded_stats()["full_packs"] == [1, 1]
    # another mesh re-packs every shard
    m.sharded_device_view(cpu_mesh("2x2"))
    assert m.sharded_stats()["full_packs"] == [2, 2]


def test_growth_repacks_every_shard():
    state = _state(8)
    m = state.mirror
    mesh = cpu_mesh("1x2")
    m.sharded_device_view(mesh)
    cap = m.cap
    for i in range(cap):
        state.add_worker_state(f"tcp://grow:{i}", nthreads=2, memory_limit=2**30)
    assert m.cap > cap
    view = m.sharded_device_view(mesh)
    assert m.sharded_stats()["full_packs"] == [2, 2]
    assert len(view["occupancy"][0]) == m.cap // 2
    assert _rows_equal_host(m, view)


def test_view_is_none_when_capacity_does_not_divide():
    state = _state(5)
    assert state.mirror.cap % 3 != 0
    assert state.mirror.sharded_device_view(cpu_mesh("1x3")) is None
    ref = _state(5, adopt=False)
    assert ref.mirror.cap == state.mirror.cap
    assert ref.mirror.sharded_device_view(ref_partition.make_engine_mesh(layout="1x3")) is None


def test_a_handed_out_view_never_changes():
    """Copy-on-write: the blocks a plan holds keep their rows after later
    writes; the next view carries the new rows."""
    state = _state(8)
    m = state.mirror
    mesh = cpu_mesh("1x2")
    v1 = m.sharded_device_view(mesh)
    before = {f: [b.clone() for b in v1[f]] for f in SHARDED_FIELDS}
    ws = next(w for w in state.workers.values() if w.idx == 5)
    state._adjust_occupancy(ws, 3.25)
    state.remove_worker_state(next(a for a, w in state.workers.items() if w.idx == 0),
                              stimulus_id="t", safe=True)
    v2 = m.sharded_device_view(mesh)
    for f in SHARDED_FIELDS:
        for b, old in zip(v1[f], before[f]):
            assert torch.equal(b, old)
    assert v2["occupancy"][1][5 - m.cap // 2].item() == np.float32(m.occupancy[5])
    assert not v2["running"][0][0].item()
    assert _rows_equal_host(m, v2)


def test_sharded_stats_equal_reference_after_the_same_sequence():
    """The same add / remove / mark sequence on both mirrors: rows and
    packs per shard are equal; the reference's bytes count a padded
    scatter of ``_bucket(rows)`` rows, the port's the rows themselves."""
    port = _state(10, "seq")
    ref = _state(10, "seq", adopt=False)
    mesh, rmesh = cpu_mesh("4x2"), ref_partition.make_engine_mesh(layout="4x2")
    rows_port = []
    for step in range(9):
        for st in (port, ref):
            _churn(st, np.random.default_rng(step), step)
        pv = port.mirror.sharded_device_view(mesh)
        rv = ref.mirror.sharded_device_view(rmesh)
        p, r = port.mirror.sharded_stats(), ref.mirror.sharded_stats()
        assert (p["n_shards"], p["rows_uploaded"], p["full_packs"]) == (
            r["n_shards"], r["rows_uploaded"], r["full_packs"])
        assert p["bytes_uploaded"] == [n * FIELD_BYTES for n in p["rows_uploaded"]]
        for f in SHARDED_FIELDS:
            np.testing.assert_array_equal(torch.cat(pv[f]).numpy(), np.asarray(rv[f]))
        rows_port.append(p["rows_uploaded"])
    assert rows_port[-1] != [0, 0]
    assert all(b >= n * FIELD_BYTES for b, n in zip(r["bytes_uploaded"], r["rows_uploaded"]))


def test_fleet_dev_path_matches_host_upload():
    """The engine fed the mirror's blocks places as it does fed the host
    arrays (capacity-sized, tombstones and unused slots not running), and
    a fresh second cycle ships zero fleet rows on every shard."""
    state = _state(40)
    for addr in sorted(state.workers)[3:9:2]:
        state.remove_worker_state(addr, stimulus_id="t", safe=True)
    m = state.mirror
    fv = m.fleet_view()
    assert m.cap == 64 and not fv.running.all()
    fleet = (fv.nthreads.copy(), fv.occupancy.copy(), fv.running.copy())
    rng = np.random.default_rng(21)
    packed = leveled.pack_graph(*random_dag(rng, 4_000), bandwidth=BW)
    for layout in ("4x2", "2x4", "1x1"):
        mesh = cpu_mesh(layout)
        host = sharded.place_graph_leveled_sharded(mesh, packed, *fleet)
        dev = sharded.place_graph_leveled_sharded(mesh, packed, *fleet,
                                                  fleet_dev=m.sharded_device_view(mesh))
        np.testing.assert_array_equal(dev.assignment, host.assignment)
        np.testing.assert_array_equal(dev.occupancy, host.occupancy)
        before = m.sharded_stats()
        again = sharded.place_graph_leveled_sharded(mesh, packed, *fleet,
                                                    fleet_dev=m.sharded_device_view(mesh))
        after = m.sharded_stats()
        assert after["rows_uploaded"] == before["rows_uploaded"]
        assert after["full_packs"] == before["full_packs"]
        np.testing.assert_array_equal(again.assignment, dev.assignment)
        assert fleet[2][dev.assignment].all()


# ----------------------------------------------------------- mesh plan path


def _inc(x):
    return x + 1


def _plan_state(placement, adopt: bool, n_workers: int = 16):
    state = SchedulerState(placement=placement)
    if adopt:
        TorchMirror.adopt(state, device="cpu")
    for i in range(n_workers):
        state.add_worker_state(f"tcp://mp:{i}", nthreads=2, memory_limit=2**30, name=f"w{i}")
    tasks, deps = {}, {}
    for i in range(120):
        tasks[f"a-{i}"] = TaskSpec(_inc, (i,))
        deps[f"a-{i}"] = set()
        tasks[f"b-{i}"] = TaskSpec(_inc, (i,))
        deps[f"b-{i}"] = {f"a-{i}"}
    state.update_graph_core(tasks, deps, list(tasks), client="t", stimulus_id="mesh-plan")
    return state


def _jax_plan(layout: str):
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    with config.set({"scheduler.jax.mesh.enabled": True, "scheduler.jax.mesh.layout": layout,
                     "scheduler.jax.partitioner": "off"}):
        placement = JaxPlacement(min_batch=4, min_workers=0, sync=True, min_transfer_ratio=0)
        state = _plan_state(placement, adopt=False)
    return placement, state


def _torch_placement(layout: str, **kw) -> TorchPlacement:
    n = int(np.prod([int(p) for p in layout.split("x")]))
    return TorchPlacement(min_batch=4, min_workers=0, sync=True, min_transfer_ratio=0,
                          partitioner="off", device="cpu", mesh_enabled=True,
                          mesh_layout=layout, mesh_shard_devices=["cpu"] * n, **kw)


@pytest.mark.parametrize("layout", ["4x2", "1x1"])
def test_torch_placement_mesh_plan_path_and_stats(layout):
    """The reference's mesh plan-path test: the plan goes through the
    sharded engine, the state records one engine_shards row a shard, the
    mirror's shards stay cold on a fresh plan (one full pack, no rows),
    and the hints equal JaxPlacement's on the same batch."""
    placement = _torch_placement(layout)
    assert placement._mesh == cpu_mesh(layout)
    state = _plan_state(placement, adopt=True)
    want, ref_state = _jax_plan(layout)
    n, dw = cpu_mesh(layout).size, cpu_mesh(layout).dw
    assert placement.plans_computed == 1
    assert len(state.engine_shards) == n
    assert all(r["h2d_bytes"] > 0 and r["plans"] == 1 for r in state.engine_shards)
    ss = state.mirror.sharded_stats()
    assert ss["n_shards"] == dw
    assert ss["rows_uploaded"] == [0] * dw
    assert ss["full_packs"] == [1] * dw
    assert placement.plan == want.plan and len(placement.plan) == 120
    assert [r["h2d_bytes"] for r in state.engine_shards] == [
        r["h2d_bytes"] for r in ref_state.engine_shards]


def test_torch_placement_mesh_plans_off_the_loop():
    """The async path: the planner thread runs the sharded engine on the
    view taken on the loop, and the merge records the shards."""
    import asyncio

    async def go():
        placement = _torch_placement("2x1")
        placement.sync = False
        state = _plan_state(placement, adopt=True)
        for _ in range(200):
            if placement.plans_computed:
                break
            await asyncio.sleep(0.05)
        enabled = placement.enabled
        placement.close()
        return placement, state, enabled

    placement, state, enabled = asyncio.run(go())
    assert placement.plans_computed == 1 and enabled
    assert len(state.engine_shards) == 2
    assert state.mirror.sharded_stats()["full_packs"] == [1]


def test_torch_placement_mesh_auto_default():
    """mesh_enabled defaults to auto (None): off with one visible device,
    on with two or more; False never builds."""
    single = TorchPlacement(min_batch=4, min_workers=0, sync=True, device="cpu")
    assert single.mesh_enabled is None and single._mesh is None
    off = TorchPlacement(device="cpu", mesh_enabled=False, mesh_shard_devices=["cpu"] * 8)
    assert off._mesh is None
    multi = TorchPlacement(device="cpu", mesh_shard_devices=["cpu"] * 8)
    assert multi._mesh == cpu_mesh("4x2")
    assert TorchPlacement(device="cpu", mesh_shard_devices=["cpu"] * 8,
                          mesh_devices=2)._mesh == cpu_mesh("2x1")


def test_torch_placement_bad_layout_raises_at_construction():
    """Divergence from the reference, which logs an unsatisfiable layout
    and plans on the single-device engine (test_sharded_engine.py's
    test_jax_placement_bad_layout_falls_back): the port raises where the
    placement is built."""
    with pytest.raises(ValueError, match="needs 4096 devices"):
        TorchPlacement(device="cpu", mesh_enabled=True, mesh_layout="64x64")


def test_torch_placement_sharded_failure_propagates(monkeypatch, caplog):
    """Divergence from the reference, which falls back to the
    single-device engine when the sharded one fails: the port's plan
    fails, the planner logs it and disables itself, and no engine runs in
    its place."""
    single = []

    def broken(*args, **kwargs):
        raise RuntimeError("shard launch refused")

    monkeypatch.setattr(sharded, "shard_tentative", broken)
    monkeypatch.setattr(leveled, "place_graph_leveled",
                        lambda *a, **k: single.append(1))
    placement = _torch_placement("2x1")
    _plan_state(placement, adopt=True)
    assert not placement.enabled and placement.plans_computed == 0
    assert single == []
    assert "device planning failed" in caplog.text
