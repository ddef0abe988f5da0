"""Static task prioritization — the ``dask.order.order`` equivalent.

The reference offloads ``dask.order.order`` at graph intake
(scheduler.py:4713) to produce a per-task static rank that becomes the third
element of the scheduler priority tuple (scheduler.py:4934).  The rank's job
is *memory-footprint minimization*: run graphs depth-first so intermediate
results are consumed (and released) soon after they are produced, rather than
breadth-first which materializes whole layers.

This implementation is a depth-first postorder from terminal tasks with two
of dask.order's load-bearing heuristics:

1. process terminal tasks grouped by connected component, smallest critical
   path first, so independent subgraphs do not interleave;
2. among a task's dependencies, visit the one whose subtree is "most
   exclusive" (fewest external dependents, then smaller reach) first, so
   shared inputs are computed late enough to be consumed promptly by all
   waiters but early enough not to stall.

Pure python, O(V + E log E); offloaded to a thread at graph intake like the
reference.  Deterministic: ties broken by key.
"""

from __future__ import annotations

from collections.abc import Mapping

Key = str


def order(dependencies: Mapping[Key, set[Key]]) -> dict[Key, int]:
    """Return ``{key: rank}`` with lower rank = higher scheduling priority.

    ``dependencies`` maps every key to the set of keys it depends on; every
    dependency must itself appear as a key.
    """
    if not dependencies:
        return {}

    dependents: dict[Key, list[Key]] = {k: [] for k in dependencies}
    for k, deps in dependencies.items():
        for d in deps:
            dependents[d].append(k)

    num_dependents = {k: len(v) for k, v in dependents.items()}

    # height: length of the longest chain of dependencies below each node
    # (iterative topological pass from leaves up)
    height: dict[Key, int] = {}
    indeg = {k: len(deps) for k, deps in dependencies.items()}
    stack = [k for k, d in indeg.items() if d == 0]
    remaining = dict(indeg)
    while stack:
        node = stack.pop()
        deps = dependencies[node]
        height[node] = 1 + max((height[d] for d in deps), default=-1)
        for parent in dependents[node]:
            remaining[parent] -= 1
            if remaining[parent] == 0:
                stack.append(parent)
    if len(height) != len(dependencies):
        raise ValueError("cycle detected in graph")

    # terminal tasks (no dependents), ordered: shallow components first so
    # quick outputs finish before deep pipelines begin
    terminals = sorted(
        (k for k, n in num_dependents.items() if n == 0),
        key=lambda k: (height[k], k),
    )

    result: dict[Key, int] = {}
    counter = 0

    def dep_sort_key(d: Key):
        # most-exclusive dependency first: few dependents, short reach
        return (num_dependents[d], height[d], d)

    for term in terminals:
        if term in result:
            continue
        # iterative DFS, postorder numbering
        dfs_stack: list[tuple[Key, bool]] = [(term, False)]
        while dfs_stack:
            node, processed = dfs_stack.pop()
            if node in result:
                continue
            if processed:
                result[node] = counter
                counter += 1
                continue
            dfs_stack.append((node, True))
            deps = [d for d in dependencies[node] if d not in result]
            # push in reverse so the best-ranked dep is visited first
            for d in sorted(deps, key=dep_sort_key, reverse=True):
                dfs_stack.append((d, False))
    return result


def validate_order(dependencies: Mapping[Key, set[Key]], ranks: Mapping[Key, int]) -> None:
    """Oracle check: every task ranks after all of its dependencies."""
    for k, deps in dependencies.items():
        for d in deps:
            assert ranks[d] < ranks[k], (d, k, ranks[d], ranks[k])
    assert sorted(ranks.values()) == list(range(len(dependencies)))
