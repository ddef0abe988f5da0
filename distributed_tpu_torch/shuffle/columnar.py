"""Columnar (struct-of-arrays) shuffle path.

The reference hash-partitions arrow tables (shuffle/_arrow.py,
_shuffle.py:617: ``split_by_worker`` on a pyarrow Table).  The TPU-native
equivalent keeps partitions as dicts of numpy arrays — the layout jax
consumes zero-copy — and hash-splits them with vectorized numpy (one
argsort per input partition instead of a python loop per row, ~100x the
record-list path).

A partition is ``{column_name: np.ndarray}``; all columns share length.

The port's copy of ``distributed_tpu/shuffle/columnar.py``, line for line:
the routing and the joins are bit-identical to the reference's.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer: deterministic across processes
    (builtin hash() is salted per interpreter)."""
    z = x.astype(np.uint64, copy=True)
    z += np.uint64(0x9E3779B97F4A7C15)
    z ^= z >> np.uint64(30)
    z *= np.uint64(0xBF58476D1CE4E5B9)
    z ^= z >> np.uint64(27)
    z *= np.uint64(0x94D049BB133111EB)
    z ^= z >> np.uint64(31)
    return z


def hash_column(col: np.ndarray) -> np.ndarray:
    """u64 hash per row; integer/float columns vectorize, strings hash
    via the (slow) python path."""
    if col.dtype.kind in "iub":
        return _splitmix64(col)
    if col.dtype.kind == "f":
        # +0.0 canonicalizes -0.0 (equal keys must share a partition)
        c = (col + 0.0) if col.dtype.itemsize == 8 else (
            col.astype(np.float64) + 0.0
        )
        return _splitmix64(c.view(np.uint64))
    from distributed_tpu_torch.shuffle.core import stable_hash

    return np.fromiter(
        (stable_hash(x) & 0xFFFFFFFFFFFFFFFF for x in col.tolist()),
        np.uint64, count=len(col),
    )


def validate_partition(data: dict[str, np.ndarray]) -> int:
    if not isinstance(data, dict) or not data:
        raise TypeError(
            "columnar partition must be a non-empty {column: ndarray} dict"
        )
    n = None
    for c, v in data.items():
        if not isinstance(v, np.ndarray):
            raise TypeError(f"column {c!r} is not an ndarray: {type(v)}")
        if n is None:
            n = len(v)
        elif len(v) != n:
            raise ValueError(f"column {c!r} length {len(v)} != {n}")
    return n or 0


def split_arrays_by_hash(
    data: dict[str, np.ndarray], npartitions: int, on: str
) -> dict[int, dict[str, np.ndarray]]:
    """Hash-split one columnar partition into output partitions: a single
    stable argsort groups rows, then every column is sliced with one
    fancy-index per output (reference _shuffle.py:617 split_by_worker)."""
    validate_partition(data)
    keys = data[on]
    idx = (hash_column(keys) % np.uint64(npartitions)).astype(np.int64)
    order = np.argsort(idx, kind="stable")
    sorted_idx = idx[order]
    bounds = np.searchsorted(sorted_idx, np.arange(npartitions + 1))
    out: dict[int, dict[str, np.ndarray]] = {}
    for j in range(npartitions):
        lo, hi = int(bounds[j]), int(bounds[j + 1])
        if lo == hi:
            continue
        rows = order[lo:hi]
        out[j] = {c: np.ascontiguousarray(v[rows]) for c, v in data.items()}
    return out


def make_columnar_splitter(on: str) -> Callable:
    def splitter(data: Any, npartitions: int) -> dict[int, Any]:
        return split_arrays_by_hash(data, npartitions, on)

    return splitter


def concat_arrays(shards: list) -> dict[str, np.ndarray]:
    """Assemble an output partition from columnar shards."""
    if not shards:
        return {}
    cols = list(shards[0])
    return {
        c: np.concatenate([s[c] for s in shards]) if len(shards) > 1
        else shards[0][c]
        for c in cols
    }


def _empty_like_row(col: np.ndarray, n: int) -> np.ndarray:
    """n filler rows for outer-join misses: NaN for floats, minimum for
    ints (callers wanting NULL semantics should use float columns)."""
    if col.dtype.kind == "f":
        return np.full(n, np.nan, col.dtype)
    return np.zeros(n, col.dtype)


def join_arrays(
    left: dict[str, np.ndarray],
    right: dict[str, np.ndarray],
    on: str,
    how: str = "inner",
    rsuffix: str = "_right",
) -> dict[str, np.ndarray]:
    """Vectorized hash/sort-merge join of two co-partitioned columnar
    partitions (the columnar analogue of reference shuffle/_merge.py:434).

    Duplicate keys produce the full cross product per key, like a SQL
    join.  Right-side columns colliding with left names get ``rsuffix``.
    """
    if how not in ("inner", "left", "right", "outer"):
        raise ValueError(how)
    # a hash bucket may be empty on one side ({} from an unpopulated
    # output partition): treat it as zero rows of the other side's schema
    if not left or not right:
        other = right if not left else left
    if not left:
        left = {on: np.empty(0, other[on].dtype if other else np.int64)}
    if not right:
        right = {on: np.empty(0, other[on].dtype if other else np.int64)}
    lk = left[on]
    rk = right[on]
    rs = np.argsort(rk, kind="stable")
    rks = rk[rs]
    starts = np.searchsorted(rks, lk, "left")
    ends = np.searchsorted(rks, lk, "right")
    counts = ends - starts
    total = int(counts.sum())
    li = np.repeat(np.arange(len(lk)), counts)
    offs = np.zeros(len(counts), np.int64)
    if len(counts) > 1:
        offs[1:] = np.cumsum(counts[:-1])
    ri_flat = (
        np.arange(total, dtype=np.int64)
        - np.repeat(offs, counts)
        + np.repeat(starts, counts)
    )
    ri = rs[ri_flat]

    def rname(c: str) -> str:
        return c if c == on else (c + rsuffix if c in left else c)

    out = {c: v[li] for c, v in left.items()}
    for c, v in right.items():
        if c == on:
            continue
        out[rname(c)] = v[ri]

    if how in ("left", "outer"):
        miss_l = np.nonzero(counts == 0)[0]
        if len(miss_l):
            for c, v in left.items():
                out[c] = np.concatenate([out[c], v[miss_l]])
            for c, v in right.items():
                if c == on:
                    continue
                out[rname(c)] = np.concatenate(
                    [out[rname(c)], _empty_like_row(v, len(miss_l))]
                )
    if how in ("right", "outer"):
        # unmatched RIGHT rows, with left-column filler — implemented
        # natively so column naming stays identical across join types
        # (left columns bare, right columns suffixed)
        matched_r = np.zeros(len(rk), bool)
        matched_r[ri] = True
        miss_r = np.nonzero(~matched_r)[0]
        if len(miss_r):
            for c, v in left.items():
                if c == on:
                    out[c] = np.concatenate([out[c], rk[miss_r]])
                else:
                    out[c] = np.concatenate(
                        [out[c], _empty_like_row(v, len(miss_r))]
                    )
            for c, v in right.items():
                if c == on:
                    continue
                out[rname(c)] = np.concatenate([out[rname(c)], v[miss_r]])
    return out
