"""The byte size of a torch tensor for the scheduler's memory model.

The counterpart of ``distributed_tpu/utils/sizeof.py``'s jax rule
(``:93-97``): a tensor counts its logical bytes,
``max(nelement * element_size, 64)``, wherever it lives.  A strided view
counts its elements, not its storage, as ``jax.Array.size * itemsize``
does.

The reference's ``sizeof`` has no rule for torch, so a tensor falls to
``sys.getsizeof`` and reports 72 B however large it is.
:func:`install_sizeof` registers :func:`tensor_sizeof` on the ``sizeof``
function the caller passes in (the port imports nothing of the reference).

The port's own :func:`sizeof`, which its ``Worker`` reports ``nbytes``
with, is the reference's (``utils/sizeof.py:12-129``, the single dispatch
with its exact-type memo), line for line but for two seams: its accelerator
rule is :func:`tensor_sizeof` for ``torch.Tensor`` where the reference's is
the jax rule, and it has no pandas rules (the reference imports pandas, and
through it pyarrow, at import where they are installed; the card's machine
has neither, and a DataFrame there sizes by ``sys.getsizeof``).
"""

from __future__ import annotations

import gc
import sys
from functools import singledispatch
from typing import Any

import torch

from distributed_tpu_torch._install import Installed, install


def tensor_sizeof(t: torch.Tensor) -> int:
    """Logical bytes of ``t``, at least 64."""
    return max(t.nelement() * t.element_size(), 64)


def _dispatch_state(sizeof) -> tuple:
    """(singledispatch function, its writable registry, the exact-type memo)
    behind the reference's ``sizeof``.

    ``sizeof.register`` is the reference's ``_register``, which reaches the
    dispatch through its module's globals: ``_sizeof_dispatch.register``
    adds to the dispatch's registry and ``_exact.clear()`` empties the memo
    in front of it.  The registry is exposed read-only
    (``functools.singledispatch``'s ``registry`` is a mappingproxy); the
    dict behind the proxy is its one referent."""
    names = sizeof.register.__globals__
    if "_sizeof_dispatch" not in names or "_exact" not in names:
        raise ValueError("sizeof.register does not reach a _sizeof_dispatch and an _exact memo: "
                         "not the reference's sizeof")
    dispatch, memo = names["_sizeof_dispatch"], names["_exact"]
    (registry,) = gc.get_referents(dispatch.registry)
    if not isinstance(registry, dict):
        raise TypeError(f"the dispatch registry is a {type(registry).__name__}, not a dict")
    return dispatch, registry, memo


def install_sizeof(sizeof) -> Installed:
    """Register :func:`tensor_sizeof` for ``torch.Tensor`` on the
    reference's ``sizeof`` (which clears its memo).  The handle's last
    ``uninstall()`` takes the registration out of the dispatch registry
    again (or puts back a rule that was there before), then clears the
    dispatch's cache and the memo, so a tensor sizes as it did before."""
    dispatch, registry, memo = _dispatch_state(sizeof)

    def apply():
        prior = registry.get(torch.Tensor)
        sizeof.register(torch.Tensor, tensor_sizeof)

        def undo():
            if prior is None:
                del registry[torch.Tensor]
            else:
                registry[torch.Tensor] = prior
            dispatch._clear_cache()
            memo.clear()

        return undo

    return install("sizeof", sizeof, (), apply)


# ------------------------------------------------- the port's own sizeof


@singledispatch
def _sizeof_dispatch(obj: Any) -> int:
    try:
        return sys.getsizeof(obj)
    except Exception:
        return 64


# exact-type memo in front of the singledispatch: the functools wrapper
# (kwargs plumbing + weakref cache lookup) costs more than most size
# computations — a 128-worker shuffle made ~440k dispatches per second
# of wall.  register() clears the memo so late registrations
# (numpy/torch/arrow lazy plugins, user types) still take effect.
_exact: dict = {}


def sizeof(obj: Any) -> int:
    typ = type(obj)
    impl = _exact.get(typ)
    if impl is None:
        impl = _exact[typ] = _sizeof_dispatch.dispatch(typ)
    return impl(obj)


def _register(cls, func=None):
    if func is None:
        return lambda f: _register(cls, f)
    _sizeof_dispatch.register(cls, func)
    _exact.clear()
    return func


sizeof.register = _register  # type: ignore[attr-defined]


@sizeof.register(list)
@sizeof.register(tuple)
@sizeof.register(set)
@sizeof.register(frozenset)
def _sizeof_seq(obj) -> int:
    n = sys.getsizeof(obj)
    if len(obj) > 10_000:  # sample large containers
        import itertools

        sample = list(itertools.islice(obj, 1000))
        return n + int(len(obj) / len(sample) * sum(sizeof(x) for x in sample))
    return n + sum(sizeof(x) for x in obj)


@sizeof.register(dict)
def _sizeof_dict(obj: dict) -> int:
    return (
        sys.getsizeof(obj)
        + sum(sizeof(k) for k in obj.keys())
        + sum(sizeof(v) for v in obj.values())
    )


@sizeof.register(bytes)
@sizeof.register(bytearray)
def _sizeof_bytes(obj) -> int:
    return len(obj)


@sizeof.register(memoryview)
def _sizeof_memoryview(obj: memoryview) -> int:
    return obj.nbytes


def _register_numpy() -> None:
    import numpy as np

    @sizeof.register(np.ndarray)
    def _sizeof_ndarray(obj: np.ndarray) -> int:
        return max(int(obj.nbytes), 64)

    @sizeof.register(np.generic)
    def _sizeof_npscalar(obj) -> int:
        return obj.nbytes


def _register_torch() -> None:
    sizeof.register(torch.Tensor, tensor_sizeof)


for _reg in (_register_numpy, _register_torch):
    try:
        _reg()
    except ImportError:  # pragma: no cover
        pass


def safe_sizeof(obj: Any, default: int = 1_000_000) -> int:
    """Never-raising sizeof (reference sizeof.py:safe_sizeof)."""
    try:
        return sizeof(obj)
    except Exception:
        return default
