"""await-atomicity: shared-state reads must not cross an await unguarded.

The read-await-mutate race is the class this codebase keeps fixing by
hand: the slot-reuse steal redirect (a ``ws_of`` mirror-slot binding
used to land a device plan after churn awaits), a stale ``who_has``
served after a refresh await.  An event-loop turn is the
atomicity unit — every local bound from shared cluster state is
potentially stale after ANY ``await``, and using it to mutate state or
send a message ships a decision priced against a world that no longer
exists.

The rule walks every ``async def`` in the control-plane packages and
flags a local that is

1. **bound from shared state** — a lookup into the task/worker
   registries or mirror slots (``self.state.tasks.get(k)``,
   ``state.workers[addr]``, ``mirror.ws_of[i]``), or a shared-attribute
   read off such a binding (``ts.who_has``, ``ws.processing`` — taint
   propagates);
2. **used after an await** — the same local later feeds a mutation
   (attribute/item store, ``.add/.pop/.update/...``) or a send/engine
   sink (``send``, ``write``, ``send_all``, ``transitions``,
   ``add_replica``, ...) with at least one ``await`` (or ``async for``/
   ``async with`` suspension) between binding and use;
3. **without re-validation** — no re-binding of the local and no
   ``if``/``while``/``assert`` test mentioning it between the LAST
   await and the use (a guard BEFORE the await checked stale state and
   proves nothing).

Ordering is textual (source position), which is exact for straight-line
handler code and conservative in loops.  Justified sites carry the
standard ``# graft-lint: allow[await-atomicity] reason`` pragma on the
use line, or a baseline entry.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from distributed_tpu_torch.analysis import astutils
from distributed_tpu_torch.analysis.core import Finding, LintContext, Rule, register

#: container attributes whose lookups yield live shared objects
CONTAINER_ATTRS = frozenset({"tasks", "workers", "ws_of", "aliases"})

#: attribute reads that bind live shared state regardless of their root:
#: a StreamReader's internal buffer is mutated by the transport between
#: any two loop turns (the readinto race class)
BIND_ATTRS = frozenset({"_buffer"})

#: attribute reads that keep the taint flowing (live shared sub-objects)
SHARED_ATTRS = frozenset(
    {
        "who_has",
        "has_what",
        "processing",
        "processing_on",
        "waiting_on",
        "waiters",
        "dependents",
        "dependencies",
        "erred_on",
        "coming_from",
    }
)

#: method names that mutate their receiver
MUTATORS = frozenset(
    {
        "add",
        "discard",
        "remove",
        "pop",
        "popitem",
        "popleft",
        "clear",
        "update",
        "append",
        "appendleft",
        "extend",
        "insert",
        "setdefault",
    }
)

#: callables that act on the cluster: message sends and engine entries
_SINK_RE = re.compile(
    r"^(send|send_all|send_recv|write|tell|warn|transitions|_transitions|"
    r"transitions_batch|_transition|add_replica|remove_replica|"
    r"remove_all_replicas|_add_to_processing|handle_stimulus|"
    r"update_nbytes)$|send"
)

Pos = tuple[int, int]


def _node_pos(node: ast.AST) -> Pos:
    return (node.lineno, node.col_offset)


def _node_end(node: ast.AST) -> Pos:
    return (
        getattr(node, "end_lineno", node.lineno),
        getattr(node, "end_col_offset", node.col_offset),
    )


def _dotted_chain(node: ast.AST) -> list[str]:
    """Attribute/subscript chain attrs, root-first; [] if not a chain."""
    attrs: list[str] = []
    while True:
        if isinstance(node, ast.Attribute):
            attrs.append(node.attr)
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, ast.Name):
            attrs.append(node.id)
            return list(reversed(attrs))
        else:
            return []


def _is_shared_lookup(expr: ast.AST) -> bool:
    """Does ``expr`` contain a lookup into a shared registry —
    ``<...>.tasks.get(k)``, ``<...>.workers[addr]``, ``mirror.ws_of[i]``?"""
    for node in ast.walk(expr):
        if isinstance(node, ast.Subscript):
            chain = _dotted_chain(node.value)
            if chain and chain[-1] in CONTAINER_ATTRS:
                return True
        elif isinstance(node, ast.Call):
            fn = node.func
            if (
                isinstance(fn, ast.Attribute)
                and fn.attr in ("get", "pop")
                and _dotted_chain(fn.value)
                and _dotted_chain(fn.value)[-1] in CONTAINER_ATTRS
            ):
                return True
    return False


def _is_tainted_attr_read(expr: ast.AST, tainted: set[str]) -> bool:
    """``x.who_has`` / ``x.processing`` where x is already tainted, or a
    root-independent shared binding like ``reader._buffer``."""
    for node in ast.walk(expr):
        if not isinstance(node, ast.Attribute):
            continue
        if node.attr in BIND_ATTRS:
            return True
        if node.attr in SHARED_ATTRS:
            chain = _dotted_chain(node.value)
            if chain and chain[0] in tainted:
                return True
    return False


def _mentions(expr: ast.AST, name: str) -> bool:
    return any(
        isinstance(n, ast.Name) and n.id == name for n in ast.walk(expr)
    )


class _FnScan:
    """One pass over one async def: ordered bind/await/guard/use events."""

    def __init__(self, fn: ast.AsyncFunctionDef):
        self.fn = fn
        self.binds: dict[str, list[Pos]] = {}
        self.awaits: list[Pos] = []
        self.guards: dict[str, list[Pos]] = {}
        # (name, pos, node, what)
        self.uses: list[tuple[str, Pos, ast.AST, str]] = []
        self.tainted: set[str] = set()
        self._collect()

    def _collect(self) -> None:
        nodes = sorted(
            (n for n in astutils.walk_scope(self.fn) if hasattr(n, "lineno")),
            key=_node_pos,
        )
        # pass 1: taint fixpoint over assignment order
        changed = True
        while changed:
            changed = False
            for node in nodes:
                if isinstance(node, (ast.Assign, ast.AnnAssign)):
                    value = node.value
                    targets = (
                        node.targets
                        if isinstance(node, ast.Assign)
                        else [node.target]
                    )
                elif isinstance(node, (ast.For, ast.AsyncFor)):
                    # ``for ws in self.state.workers.values():`` binds a
                    # shared object per iteration
                    value = node.iter
                    targets = [node.target]
                else:
                    continue
                if value is None:
                    continue
                names = [t.id for t in targets if isinstance(t, ast.Name)]
                # tuple unpack of a shared lookup taints every name
                for t in targets:
                    if isinstance(t, (ast.Tuple, ast.List)):
                        names.extend(
                            e.id for e in t.elts if isinstance(e, ast.Name)
                        )
                if not names:
                    continue
                if _is_shared_lookup(value) or _is_tainted_attr_read(
                    value, self.tainted
                ):
                    for n in names:
                        if n not in self.tainted:
                            self.tainted.add(n)
                            changed = True
        # pass 2: ordered events
        for node in nodes:
            if isinstance(node, (ast.Await, ast.AsyncFor, ast.AsyncWith)):
                self.awaits.append(_node_pos(node))
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.For,
                                 ast.AsyncFor)) and not (
                isinstance(node, ast.AnnAssign) and node.value is None
            ):
                # a bare ``ts: TaskState`` annotation binds nothing — it
                # must not move last_bind past an await
                targets = (
                    node.targets
                    if isinstance(node, ast.Assign)
                    else [node.target]
                )
                # an Assign binds when its statement ends; a for-target
                # binds at the loop header (end of the iterable)
                bind_pos = (
                    _node_end(node.iter)
                    if isinstance(node, (ast.For, ast.AsyncFor))
                    else _node_end(node)
                )
                for t in targets:
                    tnames = (
                        [t]
                        if isinstance(t, ast.Name)
                        else list(t.elts)
                        if isinstance(t, (ast.Tuple, ast.List))
                        else []
                    )
                    for tn in tnames:
                        if isinstance(tn, ast.Name):
                            self.binds.setdefault(tn.id, []).append(bind_pos)
            for test in self._tests_of(node):
                for sub in ast.walk(test):
                    if isinstance(sub, ast.Name):
                        self.guards.setdefault(sub.id, []).append(
                            _node_pos(test)
                        )
            self._collect_uses(node)
        self.awaits.sort()

    @staticmethod
    def _tests_of(node: ast.AST):
        if isinstance(node, (ast.If, ast.While, ast.IfExp)):
            yield node.test
        elif isinstance(node, ast.Assert):
            yield node.test
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            for gen in node.generators:
                for cond in gen.ifs:
                    yield cond

    def _collect_uses(self, node: ast.AST) -> None:
        pos = _node_pos(node)
        # mutation: store/delete through a tainted root
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.Delete)):
            targets = (
                node.targets
                if isinstance(node, ast.Assign)
                else [node.target]
                if isinstance(node, ast.AugAssign)
                else node.targets
            )
            for t in targets:
                if isinstance(t, (ast.Attribute, ast.Subscript)):
                    chain = _dotted_chain(t)
                    # item store/delete mutates the root itself; an
                    # attribute store needs a real attr in the chain
                    deep = len(chain) > 1 or isinstance(t, ast.Subscript)
                    if chain and chain[0] in self.tainted and deep:
                        self.uses.append(
                            (chain[0], pos, node, f"mutates .{chain[-1]}")
                        )
        if not isinstance(node, ast.Call):
            return
        fn = node.func
        if isinstance(fn, ast.Attribute):
            chain = _dotted_chain(fn.value)
            # x.who_has.add(...) — mutator through a tainted root
            if (
                fn.attr in MUTATORS
                and chain
                and chain[0] in self.tainted
            ):
                self.uses.append(
                    (chain[0], pos, node, f"calls mutator .{fn.attr}()")
                )
            # sink(x, ...) — tainted local shipped into a send/engine call
            if _SINK_RE.search(fn.attr):
                for arg in [*node.args, *(kw.value for kw in node.keywords)]:
                    achain = _dotted_chain(arg)
                    if achain and achain[0] in self.tainted:
                        self.uses.append(
                            (
                                achain[0],
                                pos,
                                node,
                                f"passed to sink .{fn.attr}()",
                            )
                        )


@register
class AwaitAtomicityRule(Rule):
    name = "await-atomicity"
    description = (
        "a local bound from shared state, used in a mutation or send "
        "after an await, must be re-validated after that await"
    )
    scope = (
        "distributed_tpu_torch/scheduler/**",
        "distributed_tpu_torch/worker/**",
        "distributed_tpu_torch/comm/**",
    )

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        for mod in ctx.modules(self):
            astutils.add_parents(mod.tree)
            for fn in ast.walk(mod.tree):
                if not isinstance(fn, ast.AsyncFunctionDef):
                    continue
                yield from self._scan_fn(mod, fn)

    def _scan_fn(self, mod, fn: ast.AsyncFunctionDef) -> Iterator[Finding]:
        scan = _FnScan(fn)
        if not scan.awaits or not scan.uses:
            return
        reported: set[tuple[str, Pos]] = set()
        for name, upos, node, what in scan.uses:
            binds = [p for p in scan.binds.get(name, []) if p < upos]
            if not binds:
                continue  # parameter or outer binding: no lookup to judge
            last_bind = max(binds)
            awaits_between = [
                p for p in scan.awaits if last_bind < p < upos
            ]
            if not awaits_between:
                continue
            last_await = max(awaits_between)
            guards = [
                p
                for p in scan.guards.get(name, [])
                if last_await < p < upos
            ]
            if guards:
                continue
            key = (name, upos)
            if key in reported:
                continue
            reported.add(key)
            yield Finding(
                rule=self.name,
                path=mod.relpath,
                line=upos[0],
                col=upos[1],
                symbol=fn.name,
                message=(
                    f"local {name!r} (bound from shared state at line "
                    f"{last_bind[0]}) {what} after an await at line "
                    f"{last_await[0]} without re-validation — re-read it, "
                    "guard on live state, or pragma with a reason"
                ),
            )
