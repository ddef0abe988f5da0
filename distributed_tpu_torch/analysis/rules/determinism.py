"""determinism: unordered order must never reach a decision surface.

Cross-process determinism is the repo's foundational invariant — the
sim's same-seed digest proofs (docs/simulator.md), the durability
bounce twin (docs/durability.md), ledger-calibrated A/Bs and the
hot-standby follower's divergence alarm all assume bit-identical
replay.  Both determinism bugs found before this rule existed were
found by PYTHONHASHSEED flakes, not tooling: the scheduler relation
sets (``TaskState.dependencies``/``waiters``/... iterated by the
engine to build recommendations) and the ``saturated``/stealable
level sets (victim scan order).  This rule proves
the property statically instead of rediscovering it one flake at a
time.

**Sources** are iteration-order-unstable expressions: iteration /
``list()`` / ``tuple()`` / unpacking / ``.pop()`` / ``next(iter())``
over plain ``set``/``frozenset``-typed values, ``min``/``max`` over
such values with an order-ambiguous ``key=``, ``id()``-keyed
ordering, and ``sorted()`` whose key closes over tainted order.
Set-typedness is inferred whole-program: ``__init__`` assignments,
annotations and comprehension assignments type class attributes, and
taint flows interprocedurally through attribute reads (``ts.who_has``
where ``TaskState.who_has: set``) and locals (``x = list(tainted)``),
including derived collections (set ops, ``.copy()``, comprehensions
and dicts built in set order).

**Sinks** are the decision/replay surfaces: ``recommendations[...]``
stores and ``_transition*`` / ``transitions*`` / ``stimulus_*``
calls, message/story construction (``.append``/subscript stores
built inside a set-ordered loop), journal records and trace emits
(``record``/``emit``/``emit_task``), ledger ``file``/``join`` rows,
digest folds (``.update`` on a hash/digest receiver), and
send/replica surfaces.  A ``for`` loop over an unstable iterable is a
finding when its body reaches a sink, yields, selects by first match
(``return``/``break``), accumulates into an ordered structure, or
keys a ``dict``/``defaultdict`` row by the loop variable (row
*creation order* is how ``data_needed``-style scan order goes
allocation-dependent).

**Sanitizers**: ``OrderedSet`` (insertion-ordered — the house
container for decision-path relations), ``sorted()`` with no key or a
deterministic key, a ``min``/``max`` key carrying a total-order
tiebreak (``.address`` / ``.key`` / ``.name`` / ``.priority`` — the
house convention), a ``len(x) == 1`` guard around ``next(iter(x))``,
and the standard ``# graft-lint: allow[determinism] reason`` pragma
or baseline entry.  Bare ``min``/``max`` (no key) reduce by total
order and are value-deterministic, so they do not fire.

**Second pass — the tape_safe plugin contract**
(docs/native_engine.md): the native engine replays
``plugin.transition`` per tape row with task/scheduler state current
as of that row, but *worker occupancy and the global registries sync
at segment end*.  A class declaring ``tape_safe = True`` must read
only its arguments, row-current state and plugin-private structures —
never ``.occupancy`` and never cross-row scans (iterating
``state.tasks`` / ``state.workers``) — anywhere in the call closure
of its ``transition`` hook.  This is the precondition audit the
native plugin ABI (ROADMAP item 2) needs before the folds move into
C++.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from distributed_tpu_torch.analysis import astutils
from distributed_tpu_torch.analysis.core import Finding, LintContext, Rule, register

# ------------------------------------------------------------------ kinds
#
# "set"      plain set/frozenset: membership fine, iteration order unstable
# "dd"       defaultdict (any factory): subscript access INSERTS rows
# "dd-set"   defaultdict(set): also a "dd"; its rows are plain sets
# "ordered"  OrderedSet / sorted list / explicitly ordered container
# "tainted"  a sequence/dict whose ORDER was derived from a plain set
# "other"    anything else

SET_KINDS = frozenset({"set", "tainted"})

#: attrs that total-order a tiebreak tuple by house convention; a
#: min/max/sorted key mentioning one is deterministic
STABLE_KEY_ATTRS = frozenset({"address", "key", "name", "priority"})

#: decision/replay surface callables (matched on the called name)
_SINK_RE = re.compile(
    r"^(transitions|transitions_batch|_transitions|_transition\w*|"
    r"stimulus_\w+|emit|emit_task|record|file|file_amm|join_row|"
    r"join_amm|send|send_all|send_recv|add_replica|remove_replica|"
    r"remove_all_replicas|upsert\w*)$"
)

#: recommendation-dict names: a subscript store into one is a sink
_REC_RE = re.compile(r"^(recs|recommendations)$")

#: hash/digest receivers: ``<recv>.update(...)`` on one is a digest fold
_DIGEST_RE = re.compile(r"digest|hash|\b_h\b|hasher", re.IGNORECASE)

#: ordered-accumulator mutators: appending in set order taints the result
_APPENDERS = frozenset({"append", "extend", "appendleft", "insert", "push"})


def _ann_str(node: ast.AST | None) -> str:
    if node is None:
        return ""
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - malformed annotation
        return ""


def _ann_kind(ann: str) -> str:
    """Kind of an annotation string; '' = no opinion."""
    head = ann.split("[", 1)[0].strip().strip('"').split(".")[-1]
    if head in ("set", "frozenset", "Set", "FrozenSet"):
        return "set"
    if head in ("OrderedSet", "HeapSet"):
        return "ordered"
    if head == "defaultdict":
        inner = ann.split("[", 1)[1] if "[" in ann else ""
        if re.search(r"\bOrderedSet\b|\bHeapSet\b", inner):
            return "dd-ord"
        return "dd-set" if re.search(r"\bset\b", inner) else "dd"
    return ""


def _ann_val_kind(ann: str) -> str:
    """Value kind of a mapping annotation: ``dict[str, OrderedSet[Key]]``
    -> 'ordered', ``dict[str, set[Key]]`` -> 'set'."""
    head = ann.split("[", 1)[0].strip().strip('"').split(".")[-1]
    if head not in ("dict", "Dict", "defaultdict", "Mapping",
                    "MutableMapping"):
        return ""
    if "[" not in ann:
        return ""
    inner = ann.split("[", 1)[1].rsplit("]", 1)[0]
    value = inner.split(",", 1)[1].strip() if "," in inner else ""
    return _ann_kind(value)


def _ann_elem(ann: str) -> str:
    """Element/value class name of a container annotation, for receiver
    typing: ``dict[Key, TaskState]`` -> TaskState, ``set[WorkerState]``
    -> WorkerState."""
    if "[" not in ann:
        return ""
    inner = ann.split("[", 1)[1].rsplit("]", 1)[0]
    last = inner.split(",")[-1].strip().strip('"')
    m = re.match(r"^([A-Z]\w*)", last.split("|")[0].strip())
    return m.group(1) if m else ""


class ClassInfo:
    """Per-class attribute typing (kinds + container element classes)."""

    def __init__(self) -> None:
        self.attrs: dict[str, str] = {}
        self.elems: dict[str, str] = {}
        #: mapping-typed attrs: value kind of their rows
        self.vals: dict[str, str] = {}
        self.tape_safe = False

    def record(self, attr: str, kind: str) -> None:
        if not kind:
            return
        prev = self.attrs.get(attr)
        # an explicit ordered declaration wins (the sanitizer is the
        # stronger, deliberate statement); set beats other
        rank = {
            "other": 0, "dd": 1, "dd-set": 2, "set": 2,
            "dd-ord": 3, "ordered": 3,
        }
        if prev is None or rank.get(kind, 0) > rank.get(prev, 0):
            self.attrs[attr] = kind


def _value_kind(expr: ast.AST | None) -> str:
    """Class-level kind of an assigned value expression."""
    if expr is None:
        return ""
    if isinstance(expr, (ast.Set, ast.SetComp)):
        return "set"
    if isinstance(expr, ast.Call):
        fn = expr.func
        fname = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else ""
        )
        if fname in ("set", "frozenset"):
            return "set"
        if fname in ("OrderedSet", "HeapSet"):
            return "ordered"
        if fname == "defaultdict":
            arg = expr.args[0] if expr.args else None
            if isinstance(arg, ast.Name) and arg.id in ("set", "frozenset"):
                return "dd-set"
            if isinstance(arg, ast.Name) and arg.id in (
                "OrderedSet", "HeapSet"
            ):
                return "dd-ord"
            return "dd"
    return ""


def build_class_info(
    modules,
) -> tuple[dict[str, ClassInfo], dict[str, set[str]]]:
    """Whole-program pass: type every class's attributes from
    ``__init__``/method assignments and annotations.  Also returns
    which classes each module defines (module relpath -> class names),
    for module-local consensus."""
    out: dict[str, ClassInfo] = {}
    by_module: dict[str, set[str]] = {}
    for mod in modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            by_module.setdefault(mod.relpath, set()).add(node.name)
            info = out.setdefault(node.name, ClassInfo())
            for sub in ast.walk(node):
                # class-level ``tape_safe = True``
                if (
                    isinstance(sub, ast.Assign)
                    and any(
                        isinstance(t, ast.Name) and t.id == "tape_safe"
                        for t in sub.targets
                    )
                    and isinstance(sub.value, ast.Constant)
                    and sub.value.value is True
                ):
                    info.tape_safe = True
                targets: list[tuple[str, ast.AST | None, str]] = []
                if isinstance(sub, ast.AnnAssign):
                    ann = _ann_str(sub.annotation)
                    t = sub.target
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        targets.append((t.attr, sub.value, ann))
                    elif isinstance(t, ast.Name):
                        # class-body annotation (dataclass field)
                        targets.append((t.id, sub.value, ann))
                elif isinstance(sub, ast.Assign):
                    for t in sub.targets:
                        if (
                            isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                        ):
                            targets.append((t.attr, sub.value, ""))
                for attr, value, ann in targets:
                    kind = _ann_kind(ann) or _value_kind(value)
                    info.record(attr, kind)
                    elem = _ann_elem(ann)
                    if elem and attr not in info.elems:
                        info.elems[attr] = elem
                    vk = _ann_val_kind(ann)
                    if vk and attr not in info.vals:
                        info.vals[attr] = vk
            # properties type their attribute via the return annotation
            # (the SoA-backed relation slots: ``def who_has(self) ->
            # OrderedSet[WorkerState]``); an unannotated ``return
            # self._x`` aliases the underscore slot.  Runs after the
            # assignment walk so the alias can see the slot's kind.
            for meth in node.body:
                if not isinstance(
                    meth, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    continue
                if not any(
                    isinstance(d, ast.Name) and d.id == "property"
                    for d in meth.decorator_list
                ):
                    continue
                ann = _ann_str(meth.returns)
                if ann:
                    info.record(meth.name, _ann_kind(ann))
                    elem = _ann_elem(ann)
                    if elem and meth.name not in info.elems:
                        info.elems[meth.name] = elem
                else:
                    for stmt in meth.body:
                        if (
                            isinstance(stmt, ast.Return)
                            and isinstance(stmt.value, ast.Attribute)
                            and isinstance(stmt.value.value, ast.Name)
                            and stmt.value.value.id == "self"
                        ):
                            info.record(
                                meth.name,
                                info.attrs.get(stmt.value.attr, ""),
                            )
    return out, by_module


def consensus(
    class_info: dict[str, ClassInfo], names: set[str] | None = None
) -> dict[str, str]:
    """attr name -> kind, only where every declaring class agrees —
    the fallback when a receiver's class cannot be resolved.  Names
    typed differently across classes (``dependencies`` is OrderedSet
    on TaskState but a plain set on TaskGroup) resolve only through a
    typed receiver.  With ``names``, votes are restricted to those
    classes — the module-local consensus (an unannotated ``ts`` in the
    worker state machine holds the worker's TaskState, not the
    scheduler's)."""
    votes: dict[str, set[str]] = {}
    for cname, info in class_info.items():
        if names is not None and cname not in names:
            continue
        for attr, kind in info.attrs.items():
            votes.setdefault(attr, set()).add(kind)
    return {a: next(iter(ks)) for a, ks in votes.items() if len(ks) == 1}


def _chain_root(node: ast.AST) -> str | None:
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        node = (
            node.value
            if isinstance(node, (ast.Attribute, ast.Subscript))
            else node.func
        )
    return node.id if isinstance(node, ast.Name) else None


def _mentions_name(expr: ast.AST, names: frozenset[str] | set[str]) -> bool:
    return any(
        isinstance(n, ast.Name) and n.id in names for n in ast.walk(expr)
    )


def _mentions_attr(expr: ast.AST, attrs: frozenset[str]) -> bool:
    return any(
        isinstance(n, ast.Attribute) and n.attr in attrs
        for n in ast.walk(expr)
    )


def _mentions_id_call(expr: ast.AST) -> bool:
    for n in ast.walk(expr):
        if (
            isinstance(n, ast.Call)
            and isinstance(n.func, ast.Name)
            and n.func.id == "id"
        ):
            return True
        if isinstance(n, ast.Name) and n.id == "id":
            # bare ``key=id``
            return True
    return False


class _FnScan:
    """Type environment + findings for one function."""

    def __init__(
        self,
        rule: "DeterminismRule",
        mod,
        fn,
        cls: str | None,
        class_info: dict[str, ClassInfo],
        attr_consensus: dict[str, str],
    ) -> None:
        self.rule = rule
        self.mod = mod
        self.fn = fn
        self.cls = cls
        self.class_info = class_info
        self.attr_consensus = attr_consensus
        self.env: dict[str, str] = {}  # local -> kind
        self.cls_env: dict[str, str] = {}  # local -> class name
        if cls is not None:
            self.cls_env["self"] = cls
        self.findings: list[Finding] = []

    # ------------------------------------------------------------ typing

    def attr_kind(self, recv: ast.AST, attr: str) -> str:
        cname = self.class_of(recv)
        if cname is not None and cname in self.class_info:
            info = self.class_info[cname]
            if attr in info.attrs:
                return info.attrs[attr]
            return ""
        return self.attr_consensus.get(attr, "")

    def class_of(self, expr: ast.AST) -> str | None:
        """Instance class of an expression, where resolvable."""
        if isinstance(expr, ast.Name):
            return self.cls_env.get(expr.id)
        if isinstance(expr, ast.Call):
            fn = expr.func
            if isinstance(fn, ast.Name) and fn.id in self.class_info:
                return fn.id
            # <dict attr>.get(k) -> element class
            if isinstance(fn, ast.Attribute) and fn.attr in ("get", "pop"):
                return self._elem_of(fn.value)
        if isinstance(expr, ast.Subscript):
            return self._elem_of(expr.value)
        if isinstance(expr, ast.Attribute):
            cname = self.class_of(expr.value)
            if cname is not None and cname in self.class_info:
                elem = self.class_info[cname].elems.get(expr.attr)
                # non-container attr annotated with a class: treat the
                # elem record as authoritative only for containers; a
                # scalar attr like ``ts.group: TaskGroup`` records its
                # class under elems too via ``TaskGroup | None``
                return elem or None
        return None

    def _elem_of(self, container: ast.AST) -> str | None:
        if isinstance(container, ast.Attribute):
            cname = self.class_of(container.value)
            if cname is not None and cname in self.class_info:
                return self.class_info[cname].elems.get(container.attr)
        return None

    def kind_of(self, expr: ast.AST | None) -> str:
        if expr is None:
            return ""
        if isinstance(expr, (ast.Set, ast.SetComp)):
            return "set"
        if isinstance(expr, ast.Name):
            return self.env.get(expr.id, "")
        if isinstance(expr, ast.Attribute):
            return self.attr_kind(expr.value, expr.attr)
        if isinstance(expr, ast.Subscript):
            base = self.kind_of(expr.value)
            if base == "dd-set":
                return "set"
            if base == "dd-ord":
                return "ordered"
            return self._val_kind_of(expr.value)
        if isinstance(expr, ast.IfExp):
            return self.kind_of(expr.body) or self.kind_of(expr.orelse)
        if isinstance(expr, ast.BinOp) and isinstance(
            expr.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)
        ):
            left = self.kind_of(expr.left)
            right = self.kind_of(expr.right)
            if "tainted" in (left, right):
                return "tainted"
            if left in ("set", "ordered"):
                return left
            if right == "set":
                return "set"
            return ""
        if isinstance(expr, (ast.ListComp, ast.GeneratorExp, ast.DictComp)):
            for gen in expr.generators:
                if self.kind_of(gen.iter) in SET_KINDS:
                    return "tainted"
            return ""
        if isinstance(expr, ast.Call):
            return self._call_kind(expr)
        return ""

    def _call_kind(self, call: ast.Call) -> str:
        fn = call.func
        fname = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else ""
        )
        arg0 = call.args[0] if call.args else None
        if fname in ("set", "frozenset"):
            return "set"
        if fname in ("OrderedSet",):
            # OrderedSet(plain_set) launders unstable order into an
            # "ordered" container — the order is still unstable
            if arg0 is not None and self.kind_of(arg0) in SET_KINDS:
                return "tainted"
            return "ordered"
        if fname == "sorted":
            key = next((k.value for k in call.keywords if k.arg == "key"), None)
            if key is not None and (
                _mentions_id_call(key) or self._key_closes_over_taint(key)
            ):
                return "tainted"
            return "ordered"
        if fname in ("list", "tuple"):
            if arg0 is not None and self.kind_of(arg0) in SET_KINDS:
                return "tainted"
            return ""
        if fname == "defaultdict":
            return _value_kind(call)
        if isinstance(fn, ast.Attribute):
            recv_kind = self.kind_of(fn.value)
            if fname == "copy":
                return recv_kind
            if fname in ("union", "difference", "intersection",
                         "symmetric_difference"):
                return recv_kind if recv_kind in ("set", "ordered") else ""
            if fname in ("get", "pop"):
                if recv_kind == "dd-set":
                    return "set"
                if recv_kind == "dd-ord":
                    return "ordered"
                return self._val_kind_of(fn.value)
        return ""

    def _val_kind_of(self, container: ast.AST) -> str:
        """Row kind of a mapping-typed attribute (``in_flight_workers:
        dict[str, OrderedSet[Key]]`` rows are 'ordered')."""
        if isinstance(container, ast.Attribute):
            cname = self.class_of(container.value)
            if cname is not None and cname in self.class_info:
                return self.class_info[cname].vals.get(container.attr, "")
        return ""

    def _key_closes_over_taint(self, key: ast.AST) -> bool:
        return _mentions_name(
            key, {n for n, k in self.env.items() if k == "tainted"}
        )

    # ------------------------------------------------------------- scan

    def scan(self) -> None:
        nodes = sorted(
            (n for n in astutils.walk_scope(self.fn) if hasattr(n, "lineno")),
            key=lambda n: (n.lineno, n.col_offset),
        )
        self._type_params()
        # taint/type fixpoint over assignment order
        for _ in range(4):
            changed = self._type_pass(nodes)
            if not changed:
                break
        for node in nodes:
            self._check(node)

    def _type_params(self) -> None:
        args = self.fn.args
        for a in (*args.posonlyargs, *args.args, *args.kwonlyargs):
            ann = _ann_str(a.annotation)
            if not ann:
                continue
            kind = _ann_kind(ann)
            if kind:
                self.env[a.arg] = kind
            cls = re.match(r'^"?([A-Z]\w*)', ann.split("|")[0].strip())
            if cls and cls.group(1) in self.class_info:
                self.cls_env[a.arg] = cls.group(1)

    def _type_pass(self, nodes) -> bool:
        changed = False

        def bind(name: str, kind: str) -> None:
            nonlocal changed
            if kind and self.env.get(name) != kind:
                self.env[name] = kind
                changed = True

        def bind_cls(name: str, cname: str | None) -> None:
            nonlocal changed
            if cname and self.cls_env.get(name) != cname:
                self.cls_env[name] = cname
                changed = True

        for node in nodes:
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                value = node.value
                if value is None:
                    continue
                targets = (
                    node.targets
                    if isinstance(node, ast.Assign)
                    else [node.target]
                )
                kind = self.kind_of(value)
                if isinstance(node, ast.AnnAssign):
                    kind = _ann_kind(_ann_str(node.annotation)) or kind
                cname = self.class_of(value)
                for t in targets:
                    if isinstance(t, ast.Name):
                        bind(t.id, kind)
                        bind_cls(t.id, cname)
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                it = node.iter
                # ``for x in <set>`` binds element; loop itself judged
                # in _check.  ``for x in <dict attr>.values()`` binds
                # the element class.
                if isinstance(node.target, ast.Name):
                    tname = node.target.id
                    if isinstance(it, ast.Call) and isinstance(
                        it.func, ast.Attribute
                    ) and it.func.attr == "values":
                        bind_cls(tname, self._elem_of(it.func.value))
                    else:
                        bind_cls(tname, self._elem_of(it))
                        el = self.class_of(it)
                        if el:
                            bind_cls(tname, el)
        return changed

    # ------------------------------------------------------------ checks

    def _emit(self, node: ast.AST, message: str) -> None:
        self.findings.append(
            Finding(
                rule=self.rule.name,
                path=self.mod.relpath,
                line=node.lineno,
                col=node.col_offset,
                symbol=astutils.enclosing_function_name(node),
                message=message,
            )
        )

    def _src(self, expr: ast.AST) -> str:
        try:
            return ast.unparse(expr)
        except Exception:  # pragma: no cover
            return "<expr>"

    def _check(self, node: ast.AST) -> None:
        if isinstance(node, (ast.For, ast.AsyncFor)):
            self._check_loop(node)
        elif isinstance(node, ast.Assign):
            self._check_assign(node)
        elif isinstance(node, ast.Call):
            self._check_call(node)
        elif isinstance(node, ast.Return) and node.value is not None:
            if self.kind_of(node.value) == "tainted":
                self._emit(
                    node,
                    f"returns {self._src(node.value)!r} whose order derives "
                    "from a plain set — the caller receives hash-seed-"
                    "dependent order; sort it or build from an OrderedSet",
                )

    def _check_assign(self, node: ast.Assign) -> None:
        # unpacking a plain set: ``a, b = s`` picks arbitrary elements
        for t in node.targets:
            if isinstance(t, (ast.Tuple, ast.List)) and self.kind_of(
                node.value
            ) in SET_KINDS:
                self._emit(
                    node,
                    f"unpacks {self._src(node.value)!r} (plain set) — "
                    "element-to-name binding is hash-seed-dependent",
                )
        # storing a tainted sequence into state: the unstable order
        # escapes this function
        if self.kind_of(node.value) == "tainted":
            for t in node.targets:
                if isinstance(t, (ast.Attribute, ast.Subscript)):
                    self._emit(
                        node,
                        f"stores set-derived order {self._src(node.value)!r} "
                        f"into {self._src(t)!r} — unstable order escapes "
                        "into shared state",
                    )

    def _check_call(self, call: ast.Call) -> None:
        fn = call.func
        fname = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else ""
        )
        arg0 = call.args[0] if call.args else None
        key = next((k.value for k in call.keywords if k.arg == "key"), None)

        # id()-keyed ordering is allocation order, full stop
        if fname in ("sorted", "sort", "min", "max") and key is not None:
            if _mentions_id_call(key):
                self._emit(
                    call,
                    f"{fname}() keyed by id() — allocation-address order "
                    "is never reproducible across processes",
                )
                return

        if fname in ("min", "max") and arg0 is not None:
            k = self.kind_of(arg0)
            if k in SET_KINDS and key is not None:
                if not _mentions_attr(key, STABLE_KEY_ATTRS):
                    self._emit(
                        call,
                        f"{fname}() over {self._src(arg0)!r} (plain set) "
                        "with an order-ambiguous key — ties break by hash-"
                        "seed iteration order; add a total-order tiebreak "
                        "(.address/.key/.name/.priority) or sort first",
                    )
            return

        if fname == "sorted" and key is not None and arg0 is not None:
            if self._key_closes_over_taint(key):
                self._emit(
                    call,
                    "sorted() key closes over set-derived order — the "
                    "sort is only as stable as the tainted rank it reads",
                )
            return

        # set.pop() / next(iter(set))
        if (
            fname == "pop"
            and isinstance(fn, ast.Attribute)
            and not call.args
            and not call.keywords
            and self.kind_of(fn.value) == "set"
        ):
            self._emit(
                call,
                f"{self._src(fn.value)!r}.pop() takes a hash-seed-"
                "arbitrary element from a plain set",
            )
            return
        if (
            fname == "next"
            and isinstance(fn, ast.Name)
            and arg0 is not None
            and isinstance(arg0, ast.Call)
            and isinstance(arg0.func, ast.Name)
            and arg0.func.id == "iter"
            and arg0.args
            and self.kind_of(arg0.args[0]) in SET_KINDS
        ):
            if not self._singleton_guarded(call, arg0.args[0]):
                self._emit(
                    call,
                    f"next(iter({self._src(arg0.args[0])!r})) picks a "
                    "hash-seed-arbitrary element — guard with len()==1, "
                    "sort, or use an OrderedSet",
                )
            return

        # list()/tuple() materialization feeding a sink directly
        if isinstance(fn, ast.Attribute) and _SINK_RE.match(fname):
            for arg in [*call.args, *(k.value for k in call.keywords)]:
                ak = self.kind_of(arg)
                if ak in SET_KINDS:
                    self._emit(
                        call,
                        f"passes {self._src(arg)!r} "
                        f"({'set-derived order' if ak == 'tainted' else 'plain set'}) "
                        f"to decision/replay sink .{fname}() — the sink "
                        "observes hash-seed iteration order",
                    )

    def _singleton_guarded(self, node: ast.AST, target: ast.AST) -> bool:
        """``if len(x) == 1: ... next(iter(x))`` is deterministic."""
        tgt = self._src(target)
        cur = astutils.parent(node)
        while cur is not None and not isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef)
        ):
            if isinstance(cur, ast.If):
                for sub in ast.walk(cur.test):
                    if (
                        isinstance(sub, ast.Compare)
                        and isinstance(sub.left, ast.Call)
                        and isinstance(sub.left.func, ast.Name)
                        and sub.left.func.id == "len"
                        and sub.left.args
                        and self._src(sub.left.args[0]) == tgt
                    ):
                        return True
            cur = astutils.parent(cur)
        return False

    # -------------------------------------------------------- loop check

    def _check_loop(self, loop: ast.For | ast.AsyncFor) -> None:
        k = self.kind_of(loop.iter)
        if k not in SET_KINDS:
            return
        trigger = self._loop_trigger(loop)
        if trigger is None:
            return
        what = "set-derived order" if k == "tainted" else "plain set"
        self._emit(
            loop,
            f"iterates {self._src(loop.iter)!r} ({what} — hash-seed "
            f"iteration order) and {trigger} inside the loop — sort the "
            "iterable, use an OrderedSet, or pragma with a reason",
        )

    def _loop_trigger(self, loop: ast.For | ast.AsyncFor) -> str | None:
        loop_names = {
            n.id
            for t in [loop.target]
            for n in ast.walk(t)
            if isinstance(n, ast.Name)
        }
        stack: list[ast.AST] = list(loop.body)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            if isinstance(node, (ast.Yield, ast.YieldFrom)):
                return "yields per element (decision stream in set order)"
            if isinstance(node, ast.Return):
                return "returns on a match (first-match selection)"
            if isinstance(node, ast.Break):
                return "breaks on a match (first-match selection)"
            if isinstance(node, ast.Call):
                fn = node.func
                if isinstance(fn, ast.Attribute):
                    if _SINK_RE.match(fn.attr):
                        return (
                            f"calls decision/replay sink .{fn.attr}() "
                            "per element"
                        )
                    if fn.attr in _APPENDERS:
                        return (
                            f"appends via .{fn.attr}() (ordered "
                            "accumulator built in set order)"
                        )
                    if fn.attr == "add" and self.kind_of(
                        fn.value
                    ) == "ordered":
                        return (
                            "adds into an OrderedSet (launders set order "
                            "into an ordered container)"
                        )
                    if fn.attr == "update" and _DIGEST_RE.search(
                        self._src(fn.value)
                    ):
                        return "folds into a digest per element"
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Subscript):
                        base = t.value
                        root = _chain_root(base)
                        if (
                            isinstance(base, ast.Name)
                            and _REC_RE.match(base.id)
                        ):
                            return (
                                f"stores recommendations "
                                f"({base.id}[...] = ...) in set order"
                            )
                        if root is not None and _mentions_name(
                            t.slice, loop_names
                        ):
                            return (
                                "keys a dict row by the loop variable "
                                "(row creation order becomes scan order)"
                            )
            # defaultdict access keyed by the loop var inserts rows in
            # set order — the data_needed class of bug
            if isinstance(node, ast.Subscript) and not isinstance(
                astutils.parent(node), ast.Assign
            ):
                if self.kind_of(node.value) in ("dd", "dd-set") and (
                    _mentions_name(node.slice, loop_names)
                ):
                    return (
                        "accesses a defaultdict row keyed by the loop "
                        "variable (rows materialize in set order)"
                    )
            stack.extend(ast.iter_child_nodes(node))
        return None


# ------------------------------------------------------------- tape-safe


#: registries whose wholesale iteration inside a tape-safe hook is a
#: cross-row scan (row-current SUBSCRIPT access stays legal)
_REGISTRY_ATTRS = frozenset({"tasks", "workers"})


def _tape_safe_findings(rule: Rule, mod, tree) -> Iterator[Finding]:
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        marked = any(
            isinstance(n, ast.Assign)
            and any(
                isinstance(t, ast.Name) and t.id == "tape_safe"
                for t in n.targets
            )
            and isinstance(n.value, ast.Constant)
            and n.value.value is True
            for n in cls.body
        )
        if not marked:
            continue
        methods = {
            n.name: n
            for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        if "transition" not in methods:
            continue
        # call closure: transition + same-class helpers it reaches
        seen: set[str] = set()
        queue = ["transition"]
        while queue:
            name = queue.pop()
            if name in seen or name not in methods:
                continue
            seen.add(name)
            body = methods[name]
            for node in ast.walk(body):
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "self"
                ):
                    queue.append(node.func.attr)
                if isinstance(node, ast.Attribute) and node.attr == "occupancy":
                    yield Finding(
                        rule=rule.name,
                        path=mod.relpath,
                        line=node.lineno,
                        col=node.col_offset,
                        symbol=f"{cls.name}.{name}",
                        message=(
                            "tape_safe contract: reads .occupancy inside "
                            "the transition-hook closure — occupancy syncs "
                            "at segment end, not per tape row "
                            "(docs/native_engine.md)"
                        ),
                    )
                it = None
                if isinstance(node, (ast.For, ast.AsyncFor)):
                    it = node.iter
                elif isinstance(node, (ast.ListComp, ast.SetComp,
                                       ast.DictComp, ast.GeneratorExp)):
                    it = node.generators[0].iter
                elif (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id in ("list", "tuple", "sorted", "len",
                                         "sum")
                    and node.args
                ):
                    it = node.args[0]
                if it is None:
                    continue
                # unwrap .values()/.items()/.keys()
                base = it
                if (
                    isinstance(base, ast.Call)
                    and isinstance(base.func, ast.Attribute)
                    and base.func.attr in ("values", "items", "keys")
                ):
                    base = base.func.value
                if isinstance(base, ast.Attribute) and (
                    base.attr in _REGISTRY_ATTRS
                ):
                    yield Finding(
                        rule=rule.name,
                        path=mod.relpath,
                        line=node.lineno,
                        col=node.col_offset,
                        symbol=f"{cls.name}.{name}",
                        message=(
                            f"tape_safe contract: cross-row scan over "
                            f".{base.attr} inside the transition-hook "
                            "closure — hooks may read args and row-current "
                            "state only (docs/native_engine.md)"
                        ),
                    )


@register
class DeterminismRule(Rule):
    name = "determinism"
    description = (
        "plain-set iteration order must never reach a decision, digest, "
        "or journal surface; tape_safe hooks read row-current state only"
    )
    #: the decision/replay surfaces (see module docstring); the
    #: tape_safe pass runs wherever a marked class lives
    scope = (
        "distributed_tpu_torch/scheduler/**",
        "distributed_tpu_torch/worker/state_machine.py",
        "distributed_tpu_torch/sim/**",
        "distributed_tpu_torch/ledger.py",
        "distributed_tpu_torch/tracing.py",
        "distributed_tpu_torch/ops/stealing.py",
        "distributed_tpu_torch/ops/amm.py",
    )

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        class_info, by_module = build_class_info(ctx.all_modules)
        global_consensus = consensus(class_info)
        for mod in ctx.modules(self):
            astutils.add_parents(mod.tree)
            # module-local votes beat the global fallback
            local = consensus(class_info, by_module.get(mod.relpath, set()))
            attr_consensus = {**global_consensus, **local}
            for node in ast.walk(mod.tree):
                if not isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    continue
                cls = astutils.enclosing(node, ast.ClassDef)
                scan = _FnScan(
                    self,
                    mod,
                    node,
                    cls.name if cls is not None else None,  # type: ignore[union-attr]
                    class_info,
                    attr_consensus,
                )
                scan.scan()
                yield from scan.findings
            yield from _tape_safe_findings(self, mod, mod.tree)
