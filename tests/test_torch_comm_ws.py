"""The port's websocket comm (``comm/ws.py``) against the reference's, on
the CPU.

The framing helpers are byte-identical to the reference's on seeded
inputs, at the 7-bit, 16-bit and 64-bit payload lengths; the scheme is
registered (``get_backend("ws")``); an echo roundtrip, a 9 MiB payload that
crosses in two fragments and a whole cluster over ``ws://`` give the
reference's results, and the port's own results over ``tcp://``.  A CPU
tensor crosses ``ws://`` through the port's ``"torch"`` wire family.

Task functions live in this module: the port has no cloudpickle.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest
import torch

from distributed_tpu.client.client import Client as RefClient
from distributed_tpu.comm import ws as ref_ws
from distributed_tpu.comm.core import connect as ref_connect
from distributed_tpu.comm.core import listen as ref_listen
from distributed_tpu.deploy.local import LocalCluster as RefLocalCluster
from distributed_tpu.protocol.serialize import Serialize as RefSerialize
from distributed_tpu_torch.client.client import Client
from distributed_tpu_torch.comm import ws
from distributed_tpu_torch.comm.core import connect, get_backend, listen
from distributed_tpu_torch.deploy.local import LocalCluster
from distributed_tpu_torch.protocol.serialize import Serialize, family_counts, reset_family_counts

from conftest import gen_test

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)

# 7-bit lengths (< 126), the 16-bit field (126 .. 65535) and the 64-bit one
LENGTHS = [0, 1, 125, 126, 127, 65535, 65536, 1 << 20]


def inc(x):
    return x + 1


def triple(x):
    return 3 * x


def add5(x):
    return x + 5


def ten():
    return 10


def block(seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((64, 64), np.float32))


def identity(x):
    return x


@pytest.mark.parametrize("n", LENGTHS)
def test_framing_is_the_references_byte_for_byte(n):
    rng = np.random.default_rng(n)
    payload = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    mask = rng.integers(0, 256, 4, dtype=np.uint8).tobytes()
    key = rng.integers(0, 256, 16, dtype=np.uint8).tobytes().hex()
    assert ws._accept_key(key) == ref_ws._accept_key(key)
    for flags in (0x82, 0x02, 0x80, 0x00):
        for mkey in (None, mask):
            assert ws._ws_head(flags, n, mkey) == ref_ws._ws_head(flags, n, mkey)
    assert ws._unmask(payload, mask) == ref_ws._unmask(payload, mask)
    ours, theirs = bytearray(payload), bytearray(payload)
    ws._unmask_into(memoryview(ours), mask)
    ref_ws._unmask_into(memoryview(theirs), mask)
    assert ours == theirs and bytes(ours) == ws._unmask(payload, mask)
    control = payload[:125]
    assert ws._mask_payload(control, mask) == ref_ws._mask_payload(control, mask)
    assert ws.FRAGMENT_SIZE == ref_ws.FRAGMENT_SIZE and ws._GUID == ref_ws._GUID


def test_the_scheme_is_registered():
    backend = get_backend("ws")
    assert isinstance(backend, ws.WSBackend)
    assert backend.get_local_address_for("h:1") == "ws://h:1"
    assert backend.get_address_host("h:1") == "h"


async def _echo(listen_fn, connect_fn, addr, msg):
    received = []

    async def handle(comm):
        got = await comm.read()
        received.append(got)
        await comm.write({"echo": got})

    listener = listen_fn(addr, handle)
    await listener.start()
    try:
        comm = await connect_fn(listener.contact_address)
        await comm.write(msg)
        resp = await comm.read()
        await comm.close()
    finally:
        listener.stop()
    return listener.contact_address.split("://")[0], resp, received


@gen_test()
async def test_a_roundtrip_equals_the_references_and_tcps():
    msg = {"hello": "ws", "n": 42, "t": (1, 2.5, None), "b": b"\x00\xff"}
    ref = await _echo(ref_listen, ref_connect, "ws://127.0.0.1:0", msg)
    ours = await _echo(listen, connect, "ws://127.0.0.1:0", msg)
    over_tcp = await _echo(listen, connect, "tcp://127.0.0.1:0", msg)
    assert ref[0] == ours[0] == "ws" and over_tcp[0] == "tcp"
    assert ours[1:] == ref[1:] == over_tcp[1:]
    seen = dict(msg, t=[1, 2.5, None])  # the wire carries a tuple as a list, as msgpack does
    assert ours[1:] == ({"echo": seen}, [seen])


async def _large(listen_fn, connect_fn, serialize, addr, blob):
    async def handle(comm):
        got = await comm.read()
        data = bytes(got["blob"])
        await comm.write({"len": len(data), "sum": sum(data[::4099])})

    listener = listen_fn(addr, handle)
    await listener.start()
    try:
        comm = await connect_fn(listener.contact_address)
        await comm.write({"blob": serialize(blob)})
        resp = await comm.read()
        await comm.close()
    finally:
        listener.stop()
    return resp


@gen_test(timeout=60)
async def test_a_fragmented_payload_equals_the_references_and_tcps():
    """9 MiB: one 8 MiB fragment and a continuation frame."""
    blob = np.random.default_rng(9).integers(0, 256, 9 * 2**20, dtype=np.uint8).tobytes()
    assert len(blob) > ws.FRAGMENT_SIZE
    ref = await _large(ref_listen, ref_connect, RefSerialize, "ws://127.0.0.1:0", blob)
    ours = await _large(listen, connect, Serialize, "ws://127.0.0.1:0", blob)
    over_tcp = await _large(listen, connect, Serialize, "tcp://127.0.0.1:0", blob)
    assert ours == ref == over_tcp == {"len": 9 * 2**20, "sum": sum(blob[::4099])}


async def _cluster_run(cluster_cls, client_cls, protocol, **kw):
    async with cluster_cls(n_workers=2, protocol=protocol,
                           scheduler_kwargs={"validate": True},
                           worker_kwargs={"validate": True}, **kw) as cluster:
        scheme = cluster.scheduler_address.split("://")[0]
        worker_schemes = sorted(w.address.split("://")[0] for w in cluster.workers)
        async with client_cls(cluster.scheduler_address) as c:
            mapped = await asyncio.wait_for(c.gather(c.map(triple, range(10))), 60)
            w0, w1 = [w.address for w in cluster.workers]
            # a dependency fetched from the other worker, over the protocol
            a = c.submit(ten, key="ws-a", workers=[w0])
            b = c.submit(add5, a, key="ws-b", workers=[w1])
            dep = await b.result()
            many = await c.gather(c.map(inc, range(8)))
    return scheme, worker_schemes, mapped, dep, many


@gen_test(timeout=120)
async def test_a_cluster_over_ws_equals_the_references_and_tcps():
    ref = await _cluster_run(RefLocalCluster, RefClient, "ws")
    ours = await _cluster_run(LocalCluster, Client, "ws", device="cpu")
    over_tcp = await _cluster_run(LocalCluster, Client, "tcp", device="cpu")
    assert ref[:2] == ours[:2] == ("ws", ["ws", "ws"])
    assert over_tcp[:2] == ("tcp", ["tcp", "tcp"])
    assert ours[2:] == ref[2:] == over_tcp[2:]
    assert ours[2:] == ([3 * i for i in range(10)], 15, list(range(1, 9)))


@gen_test(timeout=90)
async def test_a_tensor_crosses_ws_in_the_torch_family():
    reset_family_counts()
    async with LocalCluster(n_workers=2, protocol="ws", device="cpu") as cluster:
        async with Client(cluster.scheduler_address) as c:
            w0, w1 = [w.address for w in cluster.workers]
            x = c.submit(block, 7, workers=[w0])
            y = c.submit(identity, x, workers=[w1])
            got = await y.result()
    assert torch.equal(got, block(7))
    fam = family_counts()["torch"]
    assert fam["dumps"] > 0 and fam["loads"] > 0 and fam["dumps_bytes"] >= 64 * 64 * 4
