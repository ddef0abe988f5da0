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
"""

from __future__ import annotations

import gc

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
