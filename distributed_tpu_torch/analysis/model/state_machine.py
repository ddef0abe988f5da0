"""Extract the task state machines as a whole-program model.

The paper's core objects are two stringly-typed state machines — the
scheduler ``_transitions_table`` (scheduler/state.py) and the worker
``_transitions_table`` (worker/state_machine.py) — whose coherence every
co-processor kernel silently assumes.  This module recovers the full
graph from the AST alone:

- **table sites**: every ``*_transitions_table = { (start, finish):
  handler, ... }`` dict literal, with the handler name and line per edge;
- **state vocabulary**: the ``*TASK_STATES`` tuples plus every state a
  table mentions;
- **emission sites**: every place a finish state is requested —
  ``recommendations[...] = "<state>"`` subscript stores (tuple payloads
  and ``a if c else b`` values included), recommendation dict literals /
  comprehensions (returned from handlers or fed to ``transitions``/
  ``.update``), and direct engine calls ``_transition(key, "<state>")``;
- **guard-derived start states**: an emission nested under
  ``if <obj>.state == "s"`` (or ``in ("s", ...)``) where ``<obj>`` is the
  emitted task binds its start set; everything else is "any start".

Each emission is *resolved* against its machine: ``direct`` (the pair is
in the table), ``fallback`` (both hops of the through-"released" route
exist — the ``("released", v)`` fallback in the engines), ``any-start``
(start unknown, some table edge produces the finish), or a defect the
``state-machine`` rule reports.  The same model serializes to JSON and
DOT (``--dump-model``; checked into docs/state_machine/ with a drift
test) so docs and future kernels consume one artifact.

Everything here is pure AST — the analyzed modules are never imported.
"""

from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass, field

from distributed_tpu_torch.analysis import astutils

#: recommendation-dict variable names (the two engines and their callers)
RECS_NAME = re.compile(r"^(recommendations|recs\d*|remaining)$")

#: functions whose bodies ARE the dispatch machinery: the literals inside
#: them (the released-fallback re-entry, recommendation replay) describe
#: the engine, not a stimulus, and must not count as emissions
ENGINE_FUNCS = frozenset(
    {"_transition", "_transitions", "_do_transition", "transitions"}
)

#: callables that consume a recommendations dict
_TRANSITIONS_CALLS = frozenset(
    {"transitions", "_transitions", "transitions_batch"}
)


@dataclass(frozen=True)
class Transition:
    start: str
    finish: str
    handler: str
    line: int


@dataclass
class Emission:
    """One requested finish state at one source location."""

    module: str
    line: int
    col: int
    function: str
    finish: str
    kind: str  # "subscript" | "dict" | "dict-comp" | "engine-call"
    #: guard-derived start states; None = any state possible
    starts: tuple[str, ...] | None = None
    #: filled by Machine.resolve(): "direct" | "fallback" | "any-start"
    #: | "unknown-state" | "unknown-pair"
    resolution: str = ""
    detail: str = ""


@dataclass
class Machine:
    """One transition table plus everything resolved against it."""

    module: str
    name: str  # subpackage-derived: "scheduler" / "worker"
    table_line: int
    states: tuple[str, ...] = ()
    transitions: list[Transition] = field(default_factory=list)
    #: every def whose name looks like a transition handler, name -> line
    handler_defs: dict[str, int] = field(default_factory=dict)
    #: handler names invoked directly (``self._transition_x_y(...)``)
    handler_calls: set[str] = field(default_factory=set)
    emissions: list[Emission] = field(default_factory=list)

    @property
    def table(self) -> dict[tuple[str, str], Transition]:
        return {(t.start, t.finish): t for t in self.transitions}

    @property
    def finishes(self) -> set[str]:
        return {t.finish for t in self.transitions}

    def resolve(self, em: Emission) -> None:
        """Classify one emission against this table (see module doc)."""
        table = self.table
        if em.finish not in self.states:
            em.resolution = "unknown-state"
            em.detail = f"state {em.finish!r} is in no table and no *TASK_STATES tuple"
            return
        if em.starts is None:
            if em.finish in self.finishes:
                em.resolution = "any-start"
            else:
                em.resolution = "unknown-pair"
                em.detail = (
                    f"no registered transition produces {em.finish!r} "
                    "(emission start unknown)"
                )
            return
        bad: list[str] = []
        res = "direct"
        for start in em.starts:
            if (start, em.finish) in table:
                continue
            # the engines route unknown pairs through "released":
            # (start, released) then (released, v) — both hops must exist
            if (
                "released" not in (start, em.finish)
                and (start, "released") in table
                and ("released", em.finish) in table
            ):
                res = "fallback"
                continue
            bad.append(start)
        if bad:
            em.resolution = "unknown-pair"
            em.detail = (
                f"({'|'.join(sorted(bad))}, {em.finish}) has no registered "
                "transition, directly or via the released fallback"
            )
        else:
            em.resolution = res

    def resolve_all(self) -> None:
        for em in self.emissions:
            self.resolve(em)

    def reachable_edges(self) -> set[tuple[str, str]]:
        """Table edges some resolved emission can trigger."""
        out: set[tuple[str, str]] = set()
        table = self.table
        for em in self.emissions:
            if em.resolution == "direct":
                for start in em.starts or ():
                    if (start, em.finish) in table:
                        out.add((start, em.finish))
            elif em.resolution == "fallback":
                for start in em.starts or ():
                    if (start, em.finish) in table:
                        out.add((start, em.finish))
                    else:
                        out.add((start, "released"))
                        out.add(("released", em.finish))
            elif em.resolution == "any-start":
                out.update(e for e in table if e[1] == em.finish)
        return out


# --------------------------------------------------------------- extraction


def _const_states(node: ast.AST) -> list[str]:
    """String constants an emission value can take ("s", ("s", ev),
    ``"a" if c else "b"``)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List)) and node.elts:
        return _const_states(node.elts[0])
    if isinstance(node, ast.IfExp):
        return _const_states(node.body) + _const_states(node.orelse)
    return []


def _root_name(node: ast.AST) -> str | None:
    """``dts`` from ``dts.key`` / ``dts`` / ``dts.key.x``."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _guard_starts(node: ast.AST, obj: str | None) -> tuple[str, ...] | None:
    """Start states proven by enclosing ``if <obj>.state == ...`` guards.

    Only tests of `if`s whose BODY contains the emission apply (an
    emission in the orelse sees the negation, which proves nothing
    positive).  Returns None when no guard pins the start.
    """
    if obj is None:
        return None
    states: set[str] = set()
    child = node
    cur = astutils.parent(node)
    while cur is not None and not isinstance(
        cur, (ast.FunctionDef, ast.AsyncFunctionDef)
    ):
        if isinstance(cur, ast.If) and _contains(cur.body, child):
            states.update(_test_states(cur.test, obj))
        child = cur
        cur = astutils.parent(cur)
    return tuple(sorted(states)) or None


def _contains(stmts: list[ast.stmt], node: ast.AST) -> bool:
    for s in stmts:
        if s is node:
            return True
        for sub in ast.walk(s):
            if sub is node:
                return True
    return False


def _test_states(test: ast.AST, obj: str) -> set[str]:
    """States proven by ``obj.state == "s"`` / ``obj.state in (...)``
    anywhere in a (possibly ``and``-joined) test."""
    out: set[str] = set()
    for node in ast.walk(test):
        if not isinstance(node, ast.Compare) or len(node.ops) != 1:
            continue
        left = node.left
        if not (
            isinstance(left, ast.Attribute)
            and left.attr == "state"
            and isinstance(left.value, ast.Name)
            and left.value.id == obj
        ):
            continue
        op = node.ops[0]
        comp = node.comparators[0]
        if isinstance(op, ast.Eq):
            s = astutils.const_str(comp)
            if s:
                out.add(s)
        elif isinstance(op, ast.In) and isinstance(comp, (ast.Tuple, ast.List)):
            elts = [astutils.const_str(e) for e in comp.elts]
            if all(elts):
                out.update(e for e in elts if e)
    return out


def _enclosing_name(node: ast.AST) -> str:
    return astutils.enclosing_function_name(node)


def _in_engine_func(node: ast.AST) -> bool:
    return _enclosing_name(node) in ENGINE_FUNCS


def _dict_is_recs_context(node: ast.AST) -> bool:
    """Is this Dict/DictComp a recommendations payload?  True when it is
    fed to a transitions-style call, merged into a RECS-named dict,
    assigned to a RECS-named var, or returned (possibly as the first
    element of the handler's result tuple)."""
    parent = astutils.parent(node)
    # unwrap one tuple level: ``return {k: v}, {}, {}``
    if isinstance(parent, ast.Tuple) and parent.elts and parent.elts[0] is node:
        parent = astutils.parent(parent)
    if isinstance(parent, ast.Return):
        return True
    if isinstance(parent, ast.Call):
        fn = parent.func
        if isinstance(fn, ast.Attribute):
            if fn.attr in _TRANSITIONS_CALLS and node in parent.args:
                return True
            if (
                fn.attr == "update"
                and node in parent.args
                and isinstance(fn.value, ast.Name)
                and RECS_NAME.match(fn.value.id)
            ):
                return True
        elif isinstance(fn, ast.Name) and fn.id in _TRANSITIONS_CALLS:
            return node in parent.args
    if isinstance(parent, ast.Assign):
        for t in parent.targets:
            if isinstance(t, ast.Name) and RECS_NAME.match(t.id):
                return True
    return False


def _collect_emissions(relpath: str, tree: ast.Module) -> list[Emission]:
    astutils.add_parents(tree)
    out: list[Emission] = []

    def add_value(node: ast.AST, value: ast.AST, key_obj: str | None, kind: str):
        """One Emission per reachable finish, IfExp branches guarded by
        their own test on top of the enclosing ifs."""
        if _in_engine_func(node):
            return
        encl = _guard_starts(node, key_obj)
        branches: list[tuple[ast.AST, tuple[str, ...] | None]]
        if isinstance(value, ast.IfExp):
            true_extra = (
                tuple(sorted(_test_states(value.test, key_obj)))
                if key_obj is not None
                else ()
            )
            branches = [
                (value.body, true_extra or None),
                (value.orelse, None),
            ]
        else:
            branches = [(value, None)]
        for branch, extra in branches:
            for finish in _const_states(branch):
                starts = extra if extra else encl
                out.append(
                    Emission(
                        module=relpath,
                        line=node.lineno,
                        col=node.col_offset,
                        function=_enclosing_name(node),
                        finish=finish,
                        kind=kind,
                        starts=starts,
                    )
                )

    for node in ast.walk(tree):
        # recommendations[<key>] = <finish>
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if (
                isinstance(t, ast.Subscript)
                and isinstance(t.value, ast.Name)
                and RECS_NAME.match(t.value.id)
            ):
                add_value(node, node.value, _root_name(t.slice), "subscript")
        # {<key>: <finish>, ...} in a recs context
        elif isinstance(node, ast.Dict):
            if not node.keys or not _dict_is_recs_context(node):
                continue
            for k, v in zip(node.keys, node.values):
                if k is None or astutils.const_str(k) is not None:
                    continue  # **spread / string-keyed message dicts
                if not _const_states(v):
                    continue
                add_value(node, v, _root_name(k), "dict")
        elif isinstance(node, ast.DictComp):
            if astutils.const_str(node.key) is not None:
                continue
            if not _const_states(node.value) or not _dict_is_recs_context(node):
                continue
            add_value(node, node.value, _root_name(node.key), "dict-comp")
        # self._transition(key, "<finish>", ...) engine entry
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else None
            )
            if name in ("_transition", "_do_transition") and len(node.args) >= 2:
                if _const_states(node.args[1]):
                    add_value(
                        node, node.args[1], _root_name(node.args[0]),
                        "engine-call",
                    )
    return out


def _find_tables(tree: ast.Module) -> list[tuple[int, dict[tuple[str, str], tuple[str, int]]]]:
    """``(line, {(start, finish): (handler, line)})`` per table literal."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target]
        else:
            continue
        if not isinstance(node.value, ast.Dict):
            continue
        names = [astutils.dotted(t) or "" for t in targets]
        if not any(n.endswith("_transitions_table") for n in names):
            continue
        entries: dict[tuple[str, str], tuple[str, int]] = {}
        for k, v in zip(node.value.keys, node.value.values):
            if not (isinstance(k, ast.Tuple) and len(k.elts) == 2):
                continue
            start, finish = (astutils.const_str(e) for e in k.elts)
            if start is None or finish is None:
                continue
            handler = (astutils.dotted(v) or "?").rsplit(".", 1)[-1]
            entries[(start, finish)] = (handler, k.lineno)
        if entries:
            out.append((node.lineno, entries))
    return out


def _find_state_tuple(tree: ast.Module) -> tuple[str, ...]:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        names = [t.id for t in node.targets if isinstance(t, ast.Name)]
        if not any(n.endswith("TASK_STATES") for n in names):
            continue
        if isinstance(node.value, (ast.Tuple, ast.List)):
            vals = [astutils.const_str(e) for e in node.value.elts]
            if all(vals):
                return tuple(v for v in vals if v)
    return ()


def machine_name_for(relpath: str) -> str:
    """docs/state_machine artifact name: the owning subpackage."""
    parts = relpath.split("/")
    return parts[-2] if len(parts) >= 2 else parts[-1].rsplit(".", 1)[0]


def extract_machines(modules) -> list[Machine]:
    """Build one Machine per ``*_transitions_table`` found in ``modules``
    (an iterable of objects with ``.relpath`` and ``.tree`` — the lint
    engine's ModuleInfo), then attach every emission in ``modules`` to
    the machine owning its subpackage (nearest shared directory; modules
    with no machine in their lineage attach to the scheduler machine if
    one exists — client/shuffle code emits scheduler recommendations).
    """
    machines: list[Machine] = []
    mods = list(modules)
    for mod in mods:
        astutils.add_parents(mod.tree)
        for line, entries in _find_tables(mod.tree):
            table_states = {s for pair in entries for s in pair}
            states = _find_state_tuple(mod.tree)
            m = Machine(
                module=mod.relpath,
                name=machine_name_for(mod.relpath),
                table_line=line,
                states=tuple(
                    sorted(set(states) | table_states)
                ) if states else tuple(sorted(table_states)),
                transitions=[
                    Transition(start, finish, handler, hline)
                    for (start, finish), (handler, hline) in sorted(
                        entries.items()
                    )
                ],
            )
            for node in ast.walk(mod.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if node.name.startswith("_transition_"):
                        m.handler_defs[node.name] = node.lineno
                elif isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute
                ):
                    if node.func.attr.startswith("_transition_"):
                        m.handler_calls.add(node.func.attr)
            machines.append(m)

    if not machines:
        return machines
    by_dir = {m.module.rsplit("/", 1)[0]: m for m in machines}
    fallback = next(
        (m for m in machines if m.name == "scheduler"), machines[0]
    )
    for mod in mods:
        moddir = mod.relpath.rsplit("/", 1)[0]
        target = by_dir.get(moddir, fallback)
        target.emissions.extend(_collect_emissions(mod.relpath, mod.tree))
    for m in machines:
        m.emissions.sort(key=lambda e: (e.module, e.line, e.col, e.finish))
        m.resolve_all()
    return machines


# ------------------------------------------------------------ batch parity


def batch_arm_pairs(tree: ast.Module) -> list[tuple[str, str]]:
    """``(batch_fn, scalar_oracle_fn)`` name pairs in one module:
    ``stimulus_tasks_finished_batch`` -> ``stimulus_task_finished``,
    ``transitions_batch`` -> ``transitions``."""
    names = {
        n.name
        for n in ast.walk(tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }
    pairs = []
    for name in sorted(names):
        if not name.endswith("_batch"):
            continue
        scalar = name[: -len("_batch")]
        # de-pluralize: stimulus_tasks_finished -> stimulus_task_finished
        candidates = [scalar, scalar.replace("tasks", "task", 1)]
        oracle = next((c for c in candidates if c in names), "")
        pairs.append((name, oracle))
    return pairs


def reachable_set(tree: ast.Module, fn_name: str) -> tuple[set[str], set[str]]:
    """(finish states, stimulus helpers) reachable from one function:
    the transition surface a batch arm must share with its oracle."""
    fn = next(
        (
            n
            for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n.name == fn_name
        ),
        None,
    )
    if fn is None:
        return set(), set()
    finishes: set[str] = set()
    helpers: set[str] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        callee = node.func
        name = callee.attr if isinstance(callee, ast.Attribute) else (
            callee.id if isinstance(callee, ast.Name) else ""
        )
        if name in ("_transition", "_do_transition") and len(node.args) >= 2:
            finishes.update(_const_states(node.args[1]))
        elif name.startswith("stimulus_") and not name.endswith("_batch"):
            helpers.add(name)
        elif name in ("add_replica", "remove_replica"):
            helpers.add(name)
    # recommendation literals inside the arm count as finishes too
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if (
                isinstance(t, ast.Subscript)
                and isinstance(t.value, ast.Name)
                and RECS_NAME.match(t.value.id)
            ):
                finishes.update(_const_states(node.value))
        elif isinstance(node, (ast.Dict,)):
            for k, v in zip(node.keys, node.values):
                if k is not None and astutils.const_str(k) is None:
                    finishes.update(_const_states(v))
    return finishes, helpers


# ------------------------------------------------------------ serialization


def machine_to_json(machine: Machine) -> str:
    doc = {
        "module": machine.module,
        "name": machine.name,
        "table_line": machine.table_line,
        "states": list(machine.states),
        "transitions": [
            {
                "start": t.start,
                "finish": t.finish,
                "handler": t.handler,
                "line": t.line,
            }
            for t in machine.transitions
        ],
        "emissions": [
            {
                "module": e.module,
                "line": e.line,
                "function": e.function,
                "finish": e.finish,
                "kind": e.kind,
                "starts": list(e.starts) if e.starts is not None else None,
                "resolution": e.resolution,
            }
            for e in machine.emissions
        ],
    }
    return json.dumps(doc, indent=2, sort_keys=False) + "\n"


def machine_to_dot(machine: Machine) -> str:
    lines = [
        "// generated by `python -m distributed_tpu_torch.analysis --dump-model`",
        f"// source: {machine.module} (table at line {machine.table_line})",
        f"digraph {machine.name}_state_machine {{",
        "  rankdir=LR;",
        '  node [shape=box, fontname="Helvetica"];',
    ]
    for state in machine.states:
        lines.append(f'  "{state}";')
    for t in machine.transitions:
        lines.append(
            f'  "{t.start}" -> "{t.finish}" [label="{t.handler}"];'
        )
    lines.append("}")
    return "\n".join(lines) + "\n"
