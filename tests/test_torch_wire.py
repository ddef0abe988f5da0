"""The port's wire (``distributed_tpu_torch/protocol/core.py``): the
reference's frames with the header and body in ``marshal`` where the
reference packs them with msgpack.

Held against the reference's round trip, message for message:

- every message the reference's tcp comm dumps during a small reference
  cluster run, captured by wrapping its ``dumps``: the port's
  ``loads(dumps(m))`` equals the reference's, payload leaves compared
  after deserialisation, and the store-and-forward decode
  (``deserializers=False``) gives the reference's sub-headers and frame
  bytes;
- an explicit corpus of what msgpack normalises (tuples, ``bytearray``,
  sets, an ``IntEnum``, a ``str`` subclass, int keys) and refuses
  (out-of-range ints, unknown objects), raised with msgpack's type;
- split shards and zlib frames, whose headers equal the reference's;
- a foreign peer's header, refused before ``marshal.loads`` runs;
- a child process with ``msgpack``, ``cloudpickle`` and ``yaml`` blocked
  (the card's installation) running a port cluster of 2 workers over tcp.
"""

from __future__ import annotations

import asyncio
import collections
import enum
import importlib
import json
import math
import operator
import os
import pickle
import subprocess
import sys
from pathlib import Path

import msgpack
import numpy as np
import pytest
import torch

from distributed_tpu import config as ref_config
from distributed_tpu.client.client import Client as RefClient
from distributed_tpu.scheduler.server import Scheduler as RefScheduler
from distributed_tpu.worker.server import Worker as RefWorker
from distributed_tpu_torch import config as port_config
from distributed_tpu_torch.exceptions import ProtocolError

from conftest import gen_test

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
# both protocol packages export functions named after their modules
ref_core = importlib.import_module("distributed_tpu.protocol.core")
ref_ser = importlib.import_module("distributed_tpu.protocol.serialize")
ref_tcp = importlib.import_module("distributed_tpu.comm.tcp")
port_core = importlib.import_module("distributed_tpu_torch.protocol.core")
port_ser = importlib.import_module("distributed_tpu_torch.protocol.serialize")

_WRAPPERS = {
    ref_ser.Serialize: lambda o: port_ser.Serialize(o.data),
    ref_ser.ToPickle: lambda o: port_ser.ToPickle(o.data),
    ref_ser.Serialized: lambda o: port_ser.Serialized(o.header, o.frames),
    ref_ser.Pickled: lambda o: port_ser.Pickled(o.header, o.frames),
}


def to_port(obj):
    """``obj`` with the reference's protocol wrappers turned into the
    port's; containers keep their types (the walk under test normalises
    them)."""
    make = _WRAPPERS.get(type(obj))
    if make is not None:
        return make(obj)
    if isinstance(obj, dict):
        out = {k: to_port(v) for k, v in obj.items()}
        # a subclass without wrappers stays itself, for the walk to normalise
        return obj if type(obj) is not dict and all(out[k] is obj[k] for k in obj) else out
    if isinstance(obj, list):
        return [to_port(v) for v in obj]
    if isinstance(obj, tuple) and not hasattr(obj, "_fields"):
        return tuple(to_port(v) for v in obj)
    return obj


def same(a, b) -> bool:
    """Equal values of equal exact types, payload objects included."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
    if isinstance(a, BaseException):
        return same(a.args, b.args)
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    if isinstance(a, (port_ser.Serialized, port_ser.Pickled, ref_ser.Serialized, ref_ser.Pickled)):
        return same(a.header, b.header) and [bytes(f) for f in a.frames] == [bytes(f) for f in b.frames]
    try:
        if a == b:
            return True
    except Exception:
        pass
    return pickle.dumps(a) == pickle.dumps(b)


def ref_round_trip(msg, deserializers=True):
    return ref_core.loads(ref_core.dumps(msg), deserializers=deserializers)


def port_round_trip(msg, deserializers=True):
    return port_core.loads(port_core.dumps(to_port(msg)), deserializers=deserializers)


def outcome(fn, *args):
    try:
        return "ok", fn(*args)
    except Exception as exc:  # the type is what is compared
        return "raises", type(exc)


def stored(value):
    """A Serialized/Pickled leaf's header and frames as plain values."""
    if isinstance(value, (port_ser.Serialized, port_ser.Pickled, ref_ser.Serialized, ref_ser.Pickled)):
        return ("frames", value.header, [bytes(f) for f in value.frames])
    if isinstance(value, dict):
        return {k: stored(v) for k, v in value.items()}
    if isinstance(value, list):
        return [stored(v) for v in value]
    return value


def boom(x):
    raise ValueError(f"boom {x}")


@gen_test(timeout=120)
async def test_every_message_of_a_reference_run_round_trips_as_the_reference(monkeypatch):
    captured = []
    original = ref_tcp.dumps

    def spy(msg, **kwargs):
        ref = outcome(ref_round_trip, msg)
        port = outcome(port_round_trip, msg)
        ref_raw = outcome(lambda m: stored(ref_round_trip(m, False)), msg)
        port_raw = outcome(lambda m: stored(port_round_trip(m, False)), msg)
        captured.append((msg, ref, port, ref_raw, port_raw))
        return original(msg, **kwargs)

    monkeypatch.setattr(ref_tcp, "dumps", spy)
    with ref_config.set({"scheduler.jax.enabled": False}):
        async with RefScheduler(listen_addr="tcp://127.0.0.1:0", http_port=None) as s:
            async with RefWorker(s.address, nthreads=1, http_port=None) as a, \
                    RefWorker(s.address, nthreads=1, http_port=None) as b:
                async with RefClient(s.address) as c:
                    x = c.submit(np.arange, 6, workers=[a.address])
                    y = c.submit(operator.mul, x, 2, workers=[b.address])  # fetched from a
                    assert list(await y.result()) == [0, 2, 4, 6, 8, 10]
                    assert await c.gather(c.map(operator.neg, range(5))) == [0, -1, -2, -3, -4]
                    [z] = await c.scatter([{"k": (1, 2), "s": {3}}])
                    assert await c.submit(len, z).result() == 2
                    bad = c.submit(boom, 3)
                    with pytest.raises(ValueError, match="boom 3"):
                        await bad.result()
    ops = collections.Counter(
        m.get("op") for msg, *_ in captured
        for m in (msg if isinstance(msg, list) else [msg]) if isinstance(m, dict))
    assert len(captured) > 30, ops
    # requests, replies and the batched streams of every role came through
    for op in ("register-worker", "register-client", "update-graph", "get_data",
               "compute-task", "task-finished", "task-erred", "key-in-memory"):
        assert ops[op] > 0, (op, ops)
    for msg, ref, port, ref_raw, port_raw in captured:
        assert ref[0] == port[0] == "ok", (msg, ref, port)
        assert same(port[1], ref[1]), (msg, ref[1], port[1])
        assert ref_raw[0] == port_raw[0] == "ok"
        assert same(port_raw[1], ref_raw[1]), msg


class Color(enum.IntEnum):
    red = 1
    blue = 2


class Name(str):
    pass


Point = collections.namedtuple("Point", "x y")


CORPUS = {
    "tuples": {"op": "x", "a": (1, (2, 3)), "b": [(), ("s",)], "c": ((),)},
    "bytearray_memoryview": {"b": bytearray(b"xy"), "m": memoryview(b"zz"), "e": bytearray()},
    "sets": {"s": {1, 2, 3}, "f": frozenset({"a", "b"}), "nested": [{4}, set()]},
    "intenum": {"e": Color.red, "k": {Color.blue: [Color.red]}, "s": {Color.red}},
    "str_subclass": {"s": Name("x"), Name("k"): [Name("v")]},
    "int_keys": {1: "a", 2: {3: 4}, -5: None, 1.5: True, None: b"x", b"bk": 0, True: 1.0},
    "float_subclass": {"f": np.float64(1.5), "n": float("nan"), "i": float("-inf")},
    "int_limits": [2**64 - 1, -(2**63), 0, -1, 2**63],
    "set_marker": {"x": {"__dtpu_set__": [1, 2, 2]}},
    "dict_subclasses": {"o": collections.OrderedDict(a=1, b=2), "d": collections.defaultdict(list, {"z": [1]})},
    "namedtuple": {"p": Point(1, (2, 3))},
    "plain": {"op": "task-finished", "key": "x-1", "nbytes": 1024, "ok": True, "f": 0.25,
              "none": None, "b": b"\x00\xff", "u": "ünï"},
    "payloads": {"data": ref_ser.Serialize(np.arange(5.0)),
                 "t": (ref_ser.Serialize({"a": (1, 2)}), ref_ser.ToPickle(Point(1, 2))),
                 "tensor": ref_ser.Serialize(torch.arange(4, dtype=torch.int16)),
                 "err": ref_ser.ToPickle(ValueError("x"))},
    "serialized_forward": {"p": ref_ser.Serialized(*ref_ser.serialize(np.ones(3, np.int8)))},
}


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_the_corpus_round_trips_as_the_reference(name):
    msg = CORPUS[name]
    ref, port = ref_round_trip(msg), port_round_trip(msg)
    assert same(port, ref), (ref, port)
    assert same(stored(port_round_trip(msg, False)), stored(ref_round_trip(msg, False)))


REFUSED = {
    "int_too_big": {"x": 2**64},
    "int_too_small": [-(2**63) - 1],
    "object": {"x": object()},
    "numpy_int": {"n": np.int64(3)},
    "function": {"f": len},
    "tuple_key": {(1, 2): 3},
    "set_of_tuples": {"s": {(1, 2)}},
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_what_msgpack_refuses_raises_its_exception_type(name):
    """The reference raises at ``dumps`` (msgpack's packer) or at ``loads``
    (an unhashable key after msgpack's decode); the port raises the same
    type, always at ``dumps``."""
    ref = outcome(ref_round_trip, REFUSED[name])
    assert ref[0] == "raises"
    with pytest.raises(ref[1]):
        port_core.dumps(to_port(REFUSED[name]))


def _tcp_frames(frames):
    """The frames as the tcp comm hands them to ``loads``: read-only slices
    of one contiguous receive buffer."""
    buf = bytearray(b"".join(bytes(memoryview(f).cast("B")) for f in frames))
    ro = memoryview(buf).toreadonly()
    out, off = [], 0
    for f in frames:
        n = memoryview(f).nbytes
        out.append(ro[off : off + n])
        off += n
    return out


@pytest.mark.parametrize("compression", [None, "zlib"])
def test_split_shards_and_zlib_frames_equal_the_reference(compression):
    arr = np.arange(40_000, dtype=np.int64) % 7  # compressible: zlib keeps it compressed
    msg = {"op": "big", "a": ref_ser.Serialize(arr), "b": [ref_ser.Serialize(b"q" * 50_000)],
           "c": ref_ser.ToPickle({"arr": arr})}
    shard = {"comm.shard": "16KiB"}  # above the 10 kB the codecs start at
    with ref_config.set(shard), port_config.set(shard):
        ref_frames = ref_core.dumps(msg, compression=compression)
        port_frames = port_core.dumps(to_port(msg), compression=compression)
        ref_header = msgpack.unpackb(ref_frames[0], strict_map_key=False)
        port_header = port_core.read_header(port_frames[0])
        assert port_header == ref_header
        assert any(n > 1 for sub in port_header["sub-headers"] for n in sub["splits"])
        if compression:
            assert "zlib" in port_header["compression"]
        assert [bytes(memoryview(f).cast("B")) for f in port_frames[2:]] == \
            [bytes(memoryview(f).cast("B")) for f in ref_frames[2:]]
        for frames in (port_frames, _tcp_frames(port_frames)):
            out = port_core.loads(frames)
            assert np.array_equal(out["a"], arr) and out["b"] == [b"q" * 50_000]
            assert np.array_equal(out["c"]["arr"], arr)
            assert same(out, ref_core.loads(_tcp_frames(ref_frames)))


class _NoMarshal:
    """``marshal`` as the port's wire sees it, failing the test if ``loads``
    is reached."""

    version = port_core.marshal.version
    dumps = staticmethod(port_core.marshal.dumps)

    @staticmethod
    def loads(*args):
        raise AssertionError("marshal.loads ran on a foreign header")


def _foreign_headers():
    good = port_core.dumps({"op": "x"})[0]
    m = len(port_core.MAGIC)
    other_format = bytearray(good)
    other_format[m] ^= 0x7F
    other_python = bytearray(good)
    other_python[m + 2] = (other_python[m + 2] + 1) % 256
    return {
        "msgpack": (ref_core.dumps({"op": "x"})[0], "magic"),
        "short": (good[: m - 1], "magic"),
        "empty": (b"", "magic"),
        "other_marshal_format": (bytes(other_format), "marshal format"),
        "other_python": (bytes(other_python), "on Python"),
    }


@pytest.mark.parametrize("case", sorted(_foreign_headers()))
def test_a_foreign_header_is_refused_before_marshal_reads_it(case, monkeypatch):
    header, words = _foreign_headers()[case]
    body = port_core.dumps({"op": "x"})[1]
    monkeypatch.setattr(port_core, "marshal", _NoMarshal)
    with pytest.raises(ProtocolError, match=words):
        port_core.loads([header, body])


def test_the_prefix_names_marshal_and_the_python_minor_version():
    frame = port_core.dumps({"op": "x"})[0]
    assert frame.startswith(port_core.MAGIC)
    assert tuple(frame[len(port_core.MAGIC) : len(port_core.PREFIX)]) == (
        port_core.marshal.version, sys.version_info[0], sys.version_info[1])
    assert issubclass(ProtocolError, importlib.import_module(
        "distributed_tpu_torch.exceptions").CommClosedError)


_BLOCKED_CLUSTER = """
import sys
for name in ("jax", "jaxlib", "msgpack", "cloudpickle", "yaml", "distributed_tpu"):
    sys.modules[name] = None
import asyncio, json, operator
import numpy as np
import torch
torch.set_num_threads(2)
from distributed_tpu_torch import graphs
from distributed_tpu_torch.client.client import Client
from distributed_tpu_torch.protocol.serialize import family_counts
from distributed_tpu_torch.scheduler.server import Scheduler
from distributed_tpu_torch.worker.server import Worker


async def main():
    async with Scheduler(listen_addr="tcp://127.0.0.1:0", device="cpu") as s:
        async with Worker(s.address, nthreads=1) as a, Worker(s.address, nthreads=1) as b:
            async with Client(s.address) as c:
                x = c.submit(torch.arange, 6, workers=[a.address])
                y = c.submit(operator.mul, x, 2, workers=[b.address])
                g, outs = graphs.tensordot_graph(3)
                futs = c.compute_graph(g, outs)
                res = await c.gather([futs[k] for k in outs])
                out = {{
                    "y": (await y.result()).tolist(),
                    "map": await c.gather(c.map(operator.neg, range(4))),
                    "tensordot": bool(np.array_equal(np.stack([r.numpy() for r in res]).reshape(
                        3, 3, 4, 4), graphs.tensordot_expected(3))),
                    "torch_family": family_counts().get("torch", {{}}),
                    "blocked": [m for m in ("jax", "msgpack", "cloudpickle", "yaml")
                                if sys.modules.get(m) is not None],
                }}
    print(json.dumps(out))


asyncio.run(main())
"""


def test_a_port_cluster_runs_over_tcp_without_msgpack_cloudpickle_and_yaml():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _BLOCKED_CLUSTER.format()], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["y"] == [0, 2, 4, 6, 8, 10]
    assert res["map"] == [0, -1, -2, -3, -4][:4]
    assert res["tensordot"] is True
    # tensors crossed the wire through the torch family, both ways
    assert res["torch_family"]["dumps"] > 0 and res["torch_family"]["loads"] > 0
    assert res["torch_family"]["dumps_bytes"] > 0
    assert res["blocked"] == []
