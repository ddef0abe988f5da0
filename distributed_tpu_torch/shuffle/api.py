"""Shuffle graph builder + task bodies (reference shuffle/_shuffle.py,
_rechunk.py graph shapes).

``p2p_shuffle`` repartitions a list of record-partition futures into
``npartitions_out`` hash partitions; ``p2p_rechunk`` re-tiles a 1-D
chunked array; ``p2p_merge`` hash-joins two collections.  All build the
O(N+M) transfer/barrier/unpack graph whose data plane is the buffered
worker->worker push engine in ``shuffle.core``.

Task bodies fetch the CURRENT run spec from the scheduler extension
(``get_or_create_remote``), so a restarted shuffle (worker loss,
duplicate output fetch) transparently re-runs under a bumped run_id —
a body that discovers its run is stale asks the scheduler to restart
and reschedules itself (reference shuffle/_scheduler_plugin.py:336).

The port's copy of ``distributed_tpu/shuffle/api.py``, line for line.  The
builders submit through the port's ``Client._graph_to_futures``, with the
reference's task keys and annotations, and a stale epoch raises the
port's ``Reschedule``.  Task arguments travel by the standard library's
pickle (the port has no cloudpickle): a ``key`` function crosses
``inproc://`` as is, and must be importable by name over tcp.
"""

from __future__ import annotations

import uuid
from typing import Any, Callable

from distributed_tpu_torch.exceptions import Reschedule
from distributed_tpu_torch.graph.spec import Graph, TaskRef, TaskSpec
from distributed_tpu_torch.shuffle.core import (
    ShuffleClosedError,
    concat_records,
    make_keyed_splitter,
    split_records_by_hash,
    stable_hash,
)


# ------------------------------------------------------------ task bodies
# (async: they run on the worker event loop and reach the engine through
# the execution context, reference shuffle/_shuffle.py shuffle_transfer)

async def _run_for(shuffle_id: str):
    from distributed_tpu_torch.worker.context import get_worker

    worker = get_worker()
    return worker, await worker.shuffle.get_or_create_remote(shuffle_id)


async def _restart_and_reschedule(worker: Any, shuffle_id: str,
                                  run_id: int) -> None:
    """This epoch is unusable: ask the scheduler to bump it, then
    reschedule this task (it will re-run under the new epoch)."""
    try:
        await worker.rpc(worker.scheduler_addr).shuffle_restart(
            id=shuffle_id, run_id=run_id
        )
    except OSError:
        pass
    raise Reschedule(f"shuffle {shuffle_id} run {run_id} closed")


async def shuffle_transfer(data: Any, shuffle_id: str, partition_id: int,
                           key: Callable | None = None) -> int:
    worker, run = await _run_for(shuffle_id)
    splitter = make_keyed_splitter(key) if key is not None else split_records_by_hash
    try:
        await run.add_partition(data, partition_id, splitter)
    except ShuffleClosedError:
        await _restart_and_reschedule(worker, shuffle_id, run.run_id)
    return partition_id


async def shuffle_barrier(shuffle_id: str, *transfer_results: int) -> int:
    worker, run = await _run_for(shuffle_id)
    try:
        await run.barrier()
    except ShuffleClosedError:
        await _restart_and_reschedule(worker, shuffle_id, run.run_id)
    return run.run_id


async def shuffle_unpack(shuffle_id: str, partition_id: int,
                         barrier_result: int) -> Any:
    worker, run = await _run_for(shuffle_id)
    try:
        return await run.get_output_partition(partition_id, concat_records)
    except ShuffleClosedError:
        await _restart_and_reschedule(worker, shuffle_id, run.run_id)


# ------------------------------------------------------ columnar variants

async def shuffle_transfer_arrays(data: Any, shuffle_id: str,
                                  partition_id: int, on: str) -> int:
    """Columnar transfer: one vectorized hash-split per input partition
    (reference _shuffle.py:617 split_by_worker on arrow tables)."""
    from distributed_tpu_torch.shuffle.columnar import make_columnar_splitter

    worker, run = await _run_for(shuffle_id)
    try:
        await run.add_partition(data, partition_id, make_columnar_splitter(on))
    except ShuffleClosedError:
        await _restart_and_reschedule(worker, shuffle_id, run.run_id)
    return partition_id


async def shuffle_unpack_arrays(shuffle_id: str, partition_id: int,
                                barrier_result: int) -> Any:
    from distributed_tpu_torch.shuffle.columnar import concat_arrays

    worker, run = await _run_for(shuffle_id)
    try:
        return await run.get_output_partition(partition_id, concat_arrays)
    except ShuffleClosedError:
        await _restart_and_reschedule(worker, shuffle_id, run.run_id)


# ------------------------------------------------------- rechunk variants

async def rechunk_transfer(chunk: Any, shuffle_id: str, partition_id: int,
                           old_offset: int, new_bounds: tuple) -> int:
    """Route slices of a 1-D chunk to their output-chunk owners
    (reference shuffle/_rechunk.py rechunk_transfer)."""
    worker, run = await _run_for(shuffle_id)

    def splitter(data: Any, npartitions: int) -> dict[int, Any]:
        out: dict[int, Any] = {}
        n = len(data)
        for j in range(npartitions):
            lo, hi = new_bounds[j], new_bounds[j + 1]
            s = max(lo - old_offset, 0)
            e = min(hi - old_offset, n)
            if s < e:
                # tag with the absolute offset so assembly can sort
                out[j] = (old_offset + s, data[s:e])
        return out

    try:
        await run.add_partition(chunk, partition_id, splitter)
    except ShuffleClosedError:
        await _restart_and_reschedule(worker, shuffle_id, run.run_id)
    return partition_id


def _rechunk_assembler(shards: list) -> Any:
    import numpy as np

    pieces = sorted(shards, key=lambda t: t[0])
    arrays = [p[1] for p in pieces]
    if not arrays:
        return np.empty(0)
    if isinstance(arrays[0], np.ndarray):
        return np.concatenate(arrays)
    out: list = []
    for a in arrays:
        out.extend(a)
    return out


async def rechunk_unpack(shuffle_id: str, partition_id: int,
                         barrier_result: int) -> Any:
    worker, run = await _run_for(shuffle_id)
    try:
        return await run.get_output_partition(partition_id, _rechunk_assembler)
    except ShuffleClosedError:
        await _restart_and_reschedule(worker, shuffle_id, run.run_id)


# ----------------------------------------------------------- merge bodies

async def merge_transfer(data: Any, shuffle_id: str, partition_id: int,
                         side: int, key: Callable | None) -> int:
    """Tag each record with its side (left=0/right=1) before hashing on
    the join key (reference shuffle/_merge.py semantics)."""
    worker, run = await _run_for(shuffle_id)
    keyfn = key if key is not None else (lambda rec: rec[0])

    def splitter(records: Any, npartitions: int) -> dict[int, list]:
        out: dict[int, list] = {}
        for rec in records:
            j = stable_hash(keyfn(rec)) % npartitions
            out.setdefault(j, []).append((side, rec))
        return out

    try:
        await run.add_partition(data, (side, partition_id), splitter)
    except ShuffleClosedError:
        await _restart_and_reschedule(worker, shuffle_id, run.run_id)
    return partition_id


def _make_merge_assembler(key: Callable | None, how: str) -> Callable:
    keyfn = key if key is not None else (lambda rec: rec[0])

    def assembler(shards: list) -> list:
        left: dict[Any, list] = {}
        right: dict[Any, list] = {}
        for shard in shards:
            for side, rec in shard:
                (left if side == 0 else right).setdefault(
                    keyfn(rec), []
                ).append(rec)
        out = []
        for k, lrecs in left.items():
            rrecs = right.get(k)
            if rrecs:
                for lr in lrecs:
                    for rr in rrecs:
                        out.append((k, lr, rr))
            elif how in ("left", "outer"):
                for lr in lrecs:
                    out.append((k, lr, None))
        if how in ("right", "outer"):
            for k, rrecs in right.items():
                if k not in left:
                    for rr in rrecs:
                        out.append((k, None, rr))
        return out

    return assembler


async def merge_unpack(shuffle_id: str, partition_id: int,
                       barrier_result: int, key: Callable | None,
                       how: str) -> list:
    worker, run = await _run_for(shuffle_id)
    try:
        return await run.get_output_partition(
            partition_id, _make_merge_assembler(key, how)
        )
    except ShuffleClosedError:
        await _restart_and_reschedule(worker, shuffle_id, run.run_id)


# --------------------------------------------------------- graph builders

async def _create_shuffle(client: Any, shuffle_id: str,
                          npartitions_out: int, n_inputs: int,
                          device: bool = False):
    """Register the shuffle with the scheduler extension.  Returns
    ``(worker_for, device_owned)``: the partition->worker map (for
    unpack restrictions) and whether it came from pod device ownership
    (only requested — and only possible — when ``device`` is set; host
    callers ignore the flag)."""
    resp = await client.scheduler.shuffle_get_or_create(
        id=shuffle_id, npartitions_out=npartitions_out, n_inputs=n_inputs,
        device=device,
    )
    if resp.get("status") != "OK":
        raise RuntimeError(f"shuffle registration failed: {resp!r}")
    spec = resp["spec"]
    worker_for = {int(k): v for k, v in spec["worker_for"].items()}
    return worker_for, bool(resp.get("device_owned"))


def _build_pipeline(
    g: Graph,
    shuffle_id: str,
    inputs: list,
    transfer_body: Callable,
    transfer_extra: Callable,
    unpack_body: Callable,
    unpack_extra: tuple,
    npartitions_out: int,
    worker_for: dict[int, str],
) -> tuple[list[str], dict]:
    transfer_keys = []
    for i, fut in enumerate(inputs):
        k = f"{shuffle_id}-transfer-{i}"
        g.tasks[k] = TaskSpec(
            transfer_body, (TaskRef(fut.key), shuffle_id, *transfer_extra(i))
        )
        transfer_keys.append(k)
    barrier_key = f"{shuffle_id}-barrier"
    g.tasks[barrier_key] = TaskSpec(
        shuffle_barrier, (shuffle_id, *[TaskRef(k) for k in transfer_keys]),
    )
    unpack_keys = []
    annotations = {}
    for j in range(npartitions_out):
        k = f"{shuffle_id}-unpack-{j}"
        g.tasks[k] = TaskSpec(
            unpack_body, (shuffle_id, j, TaskRef(barrier_key), *unpack_extra)
        )
        unpack_keys.append(k)
        annotations[k] = {"workers": [worker_for[j]]}
    return unpack_keys, annotations


async def p2p_shuffle(
    client: Any,
    inputs: list,
    npartitions_out: int | None = None,
    key: Callable | None = None,
) -> list:
    """Hash-shuffle record partitions (futures) into npartitions_out
    partitions; returns output futures."""
    npartitions_out = npartitions_out or len(inputs)
    shuffle_id = f"shuffle-{uuid.uuid4().hex[:12]}"
    worker_for, _ = await _create_shuffle(
        client, shuffle_id, npartitions_out, len(inputs)
    )
    g = Graph()
    unpack_keys, annotations = _build_pipeline(
        g, shuffle_id, inputs,
        shuffle_transfer, lambda i: (i, key),
        shuffle_unpack, (),
        npartitions_out, worker_for,
    )
    futs = client._graph_to_futures(
        dict(g.tasks), unpack_keys, annotations_by_key=annotations,
    )
    return [futs[k] for k in unpack_keys]


async def p2p_shuffle_arrays(
    client: Any,
    inputs: list,
    npartitions_out: int | None = None,
    on: str = "key",
) -> list:
    """Hash-shuffle COLUMNAR partitions ({column: ndarray} dicts) on the
    ``on`` column; returns output futures of the same layout.  The
    columnar analogue of the reference's arrow dataframe shuffle
    (shuffle/_shuffle.py:617, _arrow.py): splitting and assembly are
    vectorized numpy, ~100x the record-list path."""
    npartitions_out = npartitions_out or len(inputs)
    shuffle_id = f"shuffle-{uuid.uuid4().hex[:12]}"
    worker_for, _ = await _create_shuffle(
        client, shuffle_id, npartitions_out, len(inputs)
    )
    g = Graph()
    unpack_keys, annotations = _build_pipeline(
        g, shuffle_id, inputs,
        shuffle_transfer_arrays, lambda i: (i, on),
        shuffle_unpack_arrays, (),
        npartitions_out, worker_for,
    )
    futs = client._graph_to_futures(
        dict(g.tasks), unpack_keys, annotations_by_key=annotations,
    )
    return [futs[k] for k in unpack_keys]


def _join_parts(lp: Any, rp: Any, on: str = "key", how: str = "inner") -> Any:
    from distributed_tpu_torch.shuffle.columnar import join_arrays

    return join_arrays(lp, rp, on, how)


async def p2p_merge_arrays(
    client: Any,
    left: list,
    right: list,
    on: str = "key",
    how: str = "inner",
    npartitions_out: int | None = None,
) -> list:
    """Columnar P2P hash join: both sides are shuffled on ``on`` with the
    SAME partition->worker assignment (the round-robin map is a pure
    function of the sorted running workers), then joined partition-wise
    with a local vectorized sort-merge join — the columnar analogue of
    reference shuffle/_merge.py:434."""
    npartitions_out = npartitions_out or max(len(left), len(right))
    louts = await p2p_shuffle_arrays(client, left, npartitions_out, on=on)
    routs = await p2p_shuffle_arrays(client, right, npartitions_out, on=on)
    return client.map(_join_parts, louts, routs, on=on, how=how, pure=False)


async def p2p_rechunk(client: Any, chunks: list, chunk_sizes: list[int],
                      new_chunk_sizes: list[int]) -> list:
    """Re-tile a 1-D chunked array (futures of chunks) onto new chunk
    boundaries (reference shuffle/_rechunk.py)."""
    assert sum(chunk_sizes) == sum(new_chunk_sizes)
    npartitions_out = len(new_chunk_sizes)
    shuffle_id = f"rechunk-{uuid.uuid4().hex[:12]}"
    worker_for, _ = await _create_shuffle(
        client, shuffle_id, npartitions_out, len(chunks)
    )

    old_offsets = [0]
    for s in chunk_sizes:
        old_offsets.append(old_offsets[-1] + s)
    new_bounds = [0]
    for s in new_chunk_sizes:
        new_bounds.append(new_bounds[-1] + s)
    new_bounds_t = tuple(new_bounds)

    g = Graph()
    unpack_keys, annotations = _build_pipeline(
        g, shuffle_id, chunks,
        rechunk_transfer, lambda i: (i, old_offsets[i], new_bounds_t),
        rechunk_unpack, (),
        npartitions_out, worker_for,
    )
    futs = client._graph_to_futures(
        dict(g.tasks), unpack_keys, annotations_by_key=annotations,
    )
    return [futs[k] for k in unpack_keys]


async def p2p_merge(
    client: Any,
    left: list,
    right: list,
    npartitions_out: int | None = None,
    key: Callable | None = None,
    how: str = "inner",
) -> list:
    """P2P hash join of two collections of record partitions (reference
    shuffle/_merge.py:434).  Records are (key, ...) tuples unless ``key``
    extracts the join key; outputs are lists of (key, left_rec,
    right_rec) with None for outer-join misses."""
    assert how in ("inner", "left", "right", "outer"), how
    npartitions_out = npartitions_out or max(len(left), len(right))
    shuffle_id = f"merge-{uuid.uuid4().hex[:12]}"
    n_inputs = len(left) + len(right)
    worker_for, _ = await _create_shuffle(
        client, shuffle_id, npartitions_out, n_inputs
    )

    g = Graph()
    transfer_keys = []
    for i, fut in enumerate(left):
        k = f"{shuffle_id}-transfer-{i}"
        g.tasks[k] = TaskSpec(
            merge_transfer, (TaskRef(fut.key), shuffle_id, i, 0, key)
        )
        transfer_keys.append(k)
    for i, fut in enumerate(right):
        k = f"{shuffle_id}-transfer-{len(left) + i}"
        g.tasks[k] = TaskSpec(
            merge_transfer, (TaskRef(fut.key), shuffle_id, i, 1, key)
        )
        transfer_keys.append(k)
    barrier_key = f"{shuffle_id}-barrier"
    g.tasks[barrier_key] = TaskSpec(
        shuffle_barrier, (shuffle_id, *[TaskRef(k) for k in transfer_keys]),
    )
    unpack_keys = []
    annotations = {}
    for j in range(npartitions_out):
        k = f"{shuffle_id}-unpack-{j}"
        g.tasks[k] = TaskSpec(
            merge_unpack, (shuffle_id, j, TaskRef(barrier_key), key, how)
        )
        unpack_keys.append(k)
        annotations[k] = {"workers": [worker_for[j]]}

    futs = client._graph_to_futures(
        dict(g.tasks), unpack_keys, annotations_by_key=annotations,
    )
    return [futs[k] for k in unpack_keys]
