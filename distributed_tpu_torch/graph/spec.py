"""Task-graph specification.

The reference has no graph spec of its own — it consumes dask's
``HighLevelGraph`` (materialized at scheduler.py:8874) where a task is a
nested tuple ``(func, arg0, arg1, ...)`` and dependencies are discovered by
scanning args for keys.  We define a cleaner explicit spec: a ``TaskSpec``
holds the callable plus args/kwargs in which dependencies appear as
``TaskRef(key)`` markers, so dependency discovery is unambiguous (no string
collision hazards) and substitution at execution time is a mechanical walk.

A ``Graph`` is ``{key: TaskSpec | literal}``; literals are inline data.
"""

from __future__ import annotations

import uuid
from collections.abc import Callable, Hashable, Iterator, Mapping
from typing import Any

Key = str


class TaskRef:
    """Marker for a dependency on another task's output."""

    __slots__ = ("key",)

    def __init__(self, key: Key):
        self.key = key

    def __repr__(self) -> str:
        return f"TaskRef({self.key!r})"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, TaskRef) and other.key == self.key

    def __hash__(self) -> int:
        return hash(("TaskRef", self.key))


class TaskSpec:
    """One task: ``fn(*args, **kwargs)`` with TaskRef placeholders.

    Equivalent to the reference's ``TaskState.run_spec``
    (scheduler.py:1188-1196) — an opaque callable plus arguments; the
    scheduler never introspects beyond dependencies.
    """

    __slots__ = ("fn", "args", "kwargs")

    def __init__(self, fn: Callable, args: tuple = (), kwargs: dict | None = None):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs or {}

    def dependencies(self) -> set[Key]:
        deps: set[Key] = set()
        _scan_refs(self.args, deps)
        _scan_refs(self.kwargs, deps)
        return deps

    def substitute(self, data: Mapping[Key, Any]) -> tuple[Callable, tuple, dict]:
        """Replace TaskRefs with concrete values for execution."""
        args = _sub(self.args, data)
        kwargs = _sub(self.kwargs, data)
        return self.fn, args, kwargs

    def __repr__(self) -> str:
        from distributed_tpu_torch.utils import funcname

        return f"TaskSpec({funcname(self.fn)}, {len(self.args)} args)"


def _scan_refs(obj: Any, out: set[Key]) -> None:
    if isinstance(obj, TaskRef):
        out.add(obj.key)
    elif isinstance(obj, (list, tuple, set, frozenset)):
        for o in obj:
            _scan_refs(o, out)
    elif isinstance(obj, dict):
        for v in obj.values():
            _scan_refs(v, out)


def _sub(obj: Any, data: Mapping[Key, Any]) -> Any:
    if isinstance(obj, TaskRef):
        return data[obj.key]
    if isinstance(obj, tuple):
        return tuple(_sub(o, data) for o in obj)
    if isinstance(obj, list):
        return [_sub(o, data) for o in obj]
    if isinstance(obj, dict):
        return {k: _sub(v, data) for k, v in obj.items()}
    return obj


class Graph:
    """A task graph: ``{key: TaskSpec | literal-data}``."""

    def __init__(self, tasks: Mapping[Key, Any] | None = None):
        self.tasks: dict[Key, Any] = dict(tasks or {})

    def __len__(self) -> int:
        return len(self.tasks)

    def __iter__(self) -> Iterator[Key]:
        return iter(self.tasks)

    def __getitem__(self, key: Key) -> Any:
        return self.tasks[key]

    def __setitem__(self, key: Key, value: Any) -> None:
        self.tasks[key] = value

    def __contains__(self, key: object) -> bool:
        return key in self.tasks

    def add(self, fn: Callable, *args: Any, key: Key | None = None, **kwargs: Any) -> Key:
        from distributed_tpu_torch.utils import funcname

        if key is None:
            key = f"{funcname(fn)}-{uuid.uuid4().hex[:16]}"
        self.tasks[key] = TaskSpec(fn, args, kwargs)
        return key

    def dependencies(self) -> dict[Key, set[Key]]:
        out: dict[Key, set[Key]] = {}
        for key, spec in self.tasks.items():
            out[key] = spec.dependencies() if isinstance(spec, TaskSpec) else set()
        return out

    def validate(self) -> None:
        deps = self.dependencies()
        for key, ds in deps.items():
            for d in ds:
                if d not in self.tasks:
                    raise ValueError(f"task {key!r} depends on missing key {d!r}")
        # cycle check via iterative DFS
        WHITE, GRAY, BLACK = 0, 1, 2
        color = dict.fromkeys(self.tasks, WHITE)
        for root in self.tasks:
            if color[root] != WHITE:
                continue
            stack: list[tuple[Key, Iterator[Key]]] = [(root, iter(deps[root]))]
            color[root] = GRAY
            while stack:
                node, it = stack[-1]
                advanced = False
                for child in it:
                    if color[child] == GRAY:
                        raise ValueError(f"cycle detected involving {child!r}")
                    if color[child] == WHITE:
                        color[child] = GRAY
                        stack.append((child, iter(deps[child])))
                        advanced = True
                        break
                if not advanced:
                    color[node] = BLACK
                    stack.pop()


def tokenize(*args: Hashable) -> str:
    """Deterministic-ish content token for key generation."""
    import hashlib
    import pickle

    try:
        payload = pickle.dumps(args, protocol=5)
    except Exception:
        payload = repr(args).encode()
    return hashlib.sha1(payload).hexdigest()[:16]
