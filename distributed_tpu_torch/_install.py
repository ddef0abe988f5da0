"""Counted, process-wide installs onto the reference's objects.

The port plugs into the reference through objects the caller passes in (a
``sizeof`` function, a serialization registry, a module).  Those objects
are process-wide, and several workers of one process (a ``LocalCluster``)
install onto the same ones.  So each :func:`install` is counted against
its target: the first applies the change, later ones only count, and only
the last handle's ``uninstall()`` undoes it, putting back exactly the
objects the first one replaced and clearing what it cleared.
"""

from __future__ import annotations

import threading
from collections.abc import Callable
from typing import Any

_lock = threading.Lock()
_active: dict[tuple[str, int], "_Entry"] = {}


class _Entry:
    def __init__(self, target: Any, params: tuple, undo: Callable[[], None]):
        self.target = target  # held, so id(target) stays this object's while installed
        self.params = params
        self.undo = undo
        self.count = 0


class Installed:
    """One count of one install.  ``uninstall()`` gives the count back; the
    last one undoes the install.  A second ``uninstall()`` of the same
    handle does nothing."""

    def __init__(self, key: tuple[str, int]):
        self._key = key
        self._done = False

    def uninstall(self) -> None:
        with _lock:
            if self._done:
                return
            self._done = True
            entry = _active[self._key]
            entry.count -= 1
            if entry.count == 0:
                del _active[self._key]
                entry.undo()


def install(kind: str, target: Any, params: tuple,
            apply: Callable[[], Callable[[], None]]) -> Installed:
    """Count an install of ``kind`` onto ``target``.  The first calls
    ``apply()``, which changes ``target`` and returns the function that
    undoes the change.  A later install with other ``params`` (another
    device, say) raises: one process holds one version of each install."""
    key = (kind, id(target))
    with _lock:
        entry = _active.get(key)
        if entry is None:
            entry = _Entry(target, params, apply())
            _active[key] = entry
        elif entry.params != params:
            raise ValueError(f"{kind} is installed here with {entry.params}, not {params}")
        entry.count += 1
    return Installed(key)


def install_count(kind: str, target: Any) -> int:
    """Handles that hold the ``kind`` install on ``target`` (0: not installed)."""
    with _lock:
        entry = _active.get((kind, id(target)))
        return entry.count if entry is not None and entry.target is target else 0
