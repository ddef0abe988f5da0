"""The port's host library (``distributed_tpu_torch/native``) against the
reference and against its plain versions, on the CPU.

- The C++ pack: every field bit for bit equal to the reference's
  ``pack_graph`` (its own C++ pack) and to the port's numpy
  ``pack_graph_numpy``, including the two-threaded heavy pass.
- The packed wire's codec: the encoders byte for byte equal to the
  reference's; the decode table against the reference's ``_dec_cost``.
- The C unpack against the numpy scatter; the loader's build rules.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tpu.ops import leveled as jl
from distributed_tpu_torch import native
from distributed_tpu_torch.ops import leveled as tl

from test_leveled import BW, random_dag
from test_torch_leveled import PACK_GRAPHS

# the suite runs as 6 pytest-xdist workers on 8 cores: torch on 2 threads a worker
# keeps the JAX package's timing tests on time (one whole-suite run: without the cap
# test_worker_ttl_evicts_silent_worker_and_recomputes failed, with it it passed)
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PACK_FIELDS = ("perm", "level", "offsets", "duration_s", "heavy_s", "heavy2_s",
               "xfer_pref_s", "xfer_pref2_s", "xfer_all_s")


def _threaded_graph():
    """The reference's threaded-pack graph: 140k tasks of up to 4 deps,
    enough edges (>= 2^18) for the two-threaded heavy pass."""
    graph = random_dag(np.random.default_rng(22), 140_000, max_deps=4)
    assert len(graph[2]) >= 1 << 18
    return graph


GRAPHS = dict(PACK_GRAPHS, threaded=_threaded_graph)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_cpp_pack_equals_reference_and_numpy_bit_for_bit(name):
    """Tolerance: none.  The numpy pack sums dependency bytes in f32 in
    edge order, as the C++ pass does, so the float fields agree too."""
    graph = GRAPHS[name]()
    got = tl.pack_graph(*graph, bandwidth=BW)
    ref = jl.pack_graph(*graph, bandwidth=BW)
    plain = tl.pack_graph_numpy(*graph, bandwidth=BW)
    assert got.n_levels == ref.n_levels == plain.n_levels
    for field in PACK_FIELDS:
        a = getattr(got, field)
        assert a.dtype == getattr(plain, field).dtype, field
        np.testing.assert_array_equal(a, getattr(ref, field), err_msg=field)
        np.testing.assert_array_equal(a, getattr(plain, field), err_msg=field)


def test_cpp_pack_cycle_raises_and_empty_graph_packs_empty():
    ones = np.ones(3, np.float32)
    cycle = (np.asarray([0, 1, 2], np.int32), np.asarray([1, 2, 0], np.int32))
    with pytest.raises(ValueError, match="cycle"):
        tl.pack_graph(ones, ones, *cycle)
    with pytest.raises(ValueError, match="cycle"):
        tl.pack_graph_numpy(ones, ones, *cycle)
    empty = (np.zeros(0, np.float32), np.zeros(0, np.float32),
             np.zeros(0, np.int32), np.zeros(0, np.int32))
    got, plain = tl.pack_graph(*empty), tl.pack_graph_numpy(*empty)
    assert got.n == 0 and got.n_levels == plain.n_levels == 0
    for field in PACK_FIELDS:
        np.testing.assert_array_equal(getattr(got, field), getattr(plain, field))
        assert getattr(got, field).dtype == getattr(plain, field).dtype


def test_cpp_pack_ignores_self_loops_and_out_of_range_edges():
    durations = np.ones(4, np.float32)
    out_bytes = np.full(4, 1e6, np.float32)
    src = np.asarray([0, 1, 1, -1, 0, 9], np.int32)
    dst = np.asarray([1, 2, 1, 2, 7, 3], np.int32)
    got = tl.pack_graph(durations, out_bytes, src, dst)
    plain = tl.pack_graph_numpy(durations, out_bytes, src, dst)
    for field in PACK_FIELDS:
        np.testing.assert_array_equal(getattr(got, field), getattr(plain, field))


# ------------------------------------------------------------------ codec


def test_cost_encode_equals_reference_byte_for_byte():
    rng = np.random.default_rng(5)
    x = np.concatenate([
        np.asarray([0.0, 1e-9, 1e-6, 1e4, 5e4, np.inf], np.float32),
        (10.0 ** rng.uniform(-8, 6, 20000)).astype(np.float32),
    ])
    got, want = tl._enc_cost(x), jl._enc_cost(x)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_heavy_pair_encode_equals_reference_and_decodes_in_torch():
    rng = np.random.default_rng(3)
    h = rng.integers(-1, 2**21 - 2, 10_000).astype(np.int32)
    h2 = rng.integers(-1, 2**21 - 2, 10_000).astype(np.int32)
    h[:3], h2[:3] = (-1, 0, 2**21 - 3), (2**21 - 3, -1, 0)
    lo, hi = tl._enc_heavy_pair(h, h2)
    want_lo, want_hi = jl._enc_heavy_pair(h, h2)
    assert lo.dtype == want_lo.dtype and hi.dtype == want_hi.dtype
    np.testing.assert_array_equal(lo, want_lo)
    np.testing.assert_array_equal(hi, want_hi)
    # the plain wave's decode: arithmetic shift, masked
    v = torch.from_numpy(lo)
    hi_t = torch.from_numpy(hi.view(np.int16)).to(torch.int32) & 0xFFFF
    np.testing.assert_array_equal(((v & 0x1FFFFF) - 1).numpy(), h)
    np.testing.assert_array_equal(((((v >> 21) & 0x7FF) | (hi_t << 11)) - 1).numpy(), h2)


def table_gap_ulps() -> np.ndarray:
    """Per code, how many f32 ulps the port's decode table lies from the
    reference's ``_dec_cost`` on XLA's CPU backend."""
    want = np.asarray(jl._dec_cost(jnp.arange(256, dtype=jnp.uint8)), np.float32)
    got = tl.cost_table().numpy()
    return np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))


def test_decode_table_against_reference():
    """Expected exact equality did NOT hold: the table is torch's f32
    ``XMIN * exp(KLOG * (c - 1))`` and XLA's CPU ``exp`` rounds a few codes
    the other way on a few codes.  The largest gap is 1 ulp; code 0 is
    exactly 0 in both.  So the packed-wire parity test applies the
    reference's quality gate."""
    gap = table_gap_ulps()
    table = tl.cost_table()
    assert table.dtype == torch.float32
    assert table.shape == (256,) and table[0].item() == 0.0
    assert gap[0] == 0
    assert gap.max() <= 1, f"decode table off by {gap.max()} ulps"
    # the codes the encoder emits decode within the quantization step
    x = np.asarray([1e-6, 1e-4, 3.1e-3, 0.9, 80.0, 9e3], np.float32)
    np.testing.assert_allclose(table.numpy()[tl._enc_cost(x)], x, rtol=0.06)


# ----------------------------------------------------------------- unpack


def test_unpack_equals_numpy_scatter():
    rng = np.random.default_rng(8)
    T = 50_000
    perm = rng.permutation(T).astype(np.int32)
    codes = ((rng.integers(0, 300, T) + 1) * 4 + rng.integers(0, 3, T)).astype(np.int32)
    level = np.zeros(T, np.int32)
    packed = tl.PackedGraph(perm=perm, level=level, offsets=np.asarray([0, T], np.int32),
                            n_levels=1, duration_s=None, heavy_s=None, heavy2_s=None,
                            xfer_pref_s=None, xfer_pref2_s=None, xfer_all_s=None)
    res = tl._finalize(packed, codes.astype(np.int16), np.ones(1, np.float32),
                       np.zeros(4, np.float32))
    want_a = np.empty(T, np.int32)
    want_c = np.empty(T, np.int8)
    want_a[perm] = codes // 4 - 1
    want_c[perm] = codes % 4
    np.testing.assert_array_equal(res.assignment, want_a)
    np.testing.assert_array_equal(res.choice, want_c)
    with pytest.raises(ValueError, match="codes"):
        tl._finalize(packed, codes[:-1], np.ones(1, np.float32), np.zeros(4, np.float32))


# ----------------------------------------------------------------- loader


def test_signatures_are_set_on_every_entry_point():
    lib = native.load()
    for name, (restype, argtypes) in native.SIGNATURES.items():
        fn = getattr(lib, name)
        assert fn.restype is restype and list(fn.argtypes) == list(argtypes), name
    assert set(native.SIGNATURES) == {
        "graphpack_full", "graphpack_topo", "graphpack_fill", "unpack_assignment"}


def test_library_lives_under_build_keyed_on_source_and_flags(monkeypatch):
    path = native.library_path()
    assert path.parent == ROOT / "build" / "torch_host"
    assert path.name.startswith("libdtpu_host-") and path.suffix == ".so"
    monkeypatch.setattr(native, "FLAGS", native.FLAGS + ("-g",))
    assert native.library_path() != path
    out = subprocess.run(["git", "check-ignore", "-q", str(path)], cwd=ROOT)
    assert out.returncode == 0


def test_build_without_compiler_raises(monkeypatch, tmp_path):
    """No g++: the loader raises, and nothing falls back to numpy."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="not found"):
        native.load()
    with pytest.raises(RuntimeError, match="not found"):
        tl.pack_graph(*PACK_GRAPHS["chain"]())
    assert not list(tmp_path.glob("*.so"))


def test_build_failure_raises(monkeypatch, tmp_path):
    bad = tmp_path / "graphpack.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="failed on graphpack.cpp"):
        native.load()
    assert not list((tmp_path / "out").glob("*"))


_BUILD_PROBE = """
import sys
from pathlib import Path
from distributed_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
native.FLAGS = native.FLAGS + ("-DPROBE",)
lib = native.load()
print(lib.graphpack_topo.restype is native._i64)
"""


def test_processes_building_at_once_each_load_a_whole_library(tmp_path):
    """Two processes build the same library into one directory at once
    (as test workers may): each links into its own temporary file and
    renames it into place, so both load a whole library."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_PROBE, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=ROOT) for _ in range(2)]
    for proc in procs:
        out, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, err
        assert out.strip() == "True"
    libs = list(tmp_path.glob("*.so"))
    assert len(libs) == 1 and not list(tmp_path.glob("*.tmp*"))
    ctypes.CDLL(str(libs[0]))
