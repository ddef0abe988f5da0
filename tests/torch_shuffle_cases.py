"""What the shuffle and coordination parity tests share: the two packages
side by side, a ``LocalCluster`` of either, and the task functions.

``tests/test_torch_shuffle.py``, ``test_torch_shuffle_storage.py`` and
``test_torch_coordination.py`` run each scenario once on the reference's
cluster and once on the port's (``device="cpu"``), on the same seeded
inputs, and compare what comes out.  Task functions live here, at module
level: the port carries functions by the standard library's pickle, by
name.
"""

from __future__ import annotations

import contextlib
import importlib
import time

import numpy as np

from distributed_tpu import config as ref_config
from distributed_tpu import coordination as ref_coordination
from distributed_tpu import exceptions as ref_exceptions
from distributed_tpu import shuffle as ref_shuffle
from distributed_tpu.client.client import Client as RefClient
from distributed_tpu.deploy.local import LocalCluster as RefLocalCluster
from distributed_tpu.graph.spec import TaskSpec as RefTaskSpec
from distributed_tpu_torch import config as port_config
from distributed_tpu_torch import coordination as port_coordination
from distributed_tpu_torch import exceptions as port_exceptions
from distributed_tpu_torch import shuffle as port_shuffle
from distributed_tpu_torch.client.client import Client
from distributed_tpu_torch.deploy.local import LocalCluster
from distributed_tpu_torch.graph.spec import TaskSpec


class Package:
    """One package's shuffle and coordination surface."""

    def __init__(self, name, local_cluster, client, task_spec, config, shuffle, coordination,
                 exceptions, cluster_kw):
        self.name, self.LocalCluster, self.Client, self.TaskSpec = name, local_cluster, client, task_spec
        self.config, self.shuffle, self.coordination = config, shuffle, coordination
        self.exceptions, self.cluster_kw = exceptions, cluster_kw
        root = "distributed_tpu_torch" if name == "port" else "distributed_tpu"
        self.api = importlib.import_module(f"{root}.shuffle.api")
        self.core = importlib.import_module(f"{root}.shuffle.core")
        self.buffers = importlib.import_module(f"{root}.shuffle.buffers")

    def __repr__(self) -> str:
        return self.name


REF = Package("reference", RefLocalCluster, RefClient, RefTaskSpec, ref_config, ref_shuffle,
              ref_coordination, ref_exceptions, {})
PORT = Package("port", LocalCluster, Client, TaskSpec, port_config, port_shuffle,
               port_coordination, port_exceptions, {"device": "cpu"})
PACKAGES = (REF, PORT)


async def new_cluster(pkg: Package, n_workers: int, threads_per_worker: int = 1):
    cluster = pkg.LocalCluster(n_workers=n_workers, threads_per_worker=threads_per_worker,
                               scheduler_kwargs={"validate": True},
                               worker_kwargs={"validate": True}, **pkg.cluster_kw)
    await cluster._start()
    return cluster


@contextlib.asynccontextmanager
async def cluster_and_client(pkg: Package, n_workers: int, threads_per_worker: int = 1):
    async with await new_cluster(pkg, n_workers, threads_per_worker) as cluster:
        async with pkg.Client(cluster.scheduler_address) as c:
            yield cluster, c


def arrays_bytes(part: dict) -> dict:
    """A columnar partition as ``{column: (dtype, bytes)}``: equal iff the
    columns are equal bit for bit."""
    return {c: (str(v.dtype), v.tobytes()) for c, v in part.items()}


# ------------------------------------------------------------ task functions


def make_partition(seed, n=50):
    rng = np.random.default_rng(seed)
    return [int(x) for x in rng.integers(0, 10_000, n)]


def big_partition(seed, n=200):
    rng = np.random.default_rng(seed)
    return [int(x) for x in rng.integers(0, 10_000, n)]


def keyed_partition(i):
    return [(k, i * 100 + n) for n, k in enumerate("abcd")]


def first(rec):
    return rec[0]


def make_chunk(lo, n):
    return np.arange(lo, lo + n)


def make_columns(i, n=5000):
    rng = np.random.default_rng(i)
    return {"key": rng.integers(0, 1000, n).astype(np.int64), "value": rng.random(n)}


def left_columns(i, n=2000):
    rng = np.random.default_rng(i)
    return {"key": rng.integers(0, 500, n).astype(np.int64), "lv": rng.random(n)}


def right_columns(i, n=2000):
    rng = np.random.default_rng(100 + i)
    return {"key": rng.integers(0, 500, n).astype(np.int64), "rv": rng.random(n)}


def left_part(i):
    return [(k, f"L{i}-{k}") for k in range(i * 3, i * 3 + 5)]


def right_part(i):
    return [(k, f"R{i}-{k}") for k in range(i * 4, i * 4 + 5)]


def outer_left():
    return [(1, "a"), (2, "b")]


def outer_right():
    return [(2, "x"), (3, "y")]


def slow_partition(i):
    time.sleep(30)
    return [i]


def triple(x):
    return x * 3


def constant(x):
    return x


def slow_result(x, delay=0.3):
    time.sleep(delay)
    return x
