"""mirror-parity: mirrored fleet fields change only through mirror-aware
helpers.

The persistent device mirror (scheduler/mirror.py) maintains per-worker
SoA rows by DELTAS: every mutation of a mirrored ``WorkerState`` field
must mark the row dirty, or the incremental arrays silently diverge
from the from-scratch oracle and the co-processor kernels (placement,
stealing, AMM, rebalance) plan against stale state.  The state machine
therefore funnels those mutations through a small registry of
mirror-aware helpers (``_adjust_occupancy``, the replica model, the
worker lifecycle, ``set_worker_status``/``set_worker_nthreads``); this
rule flags any OTHER site in scheduler code that assigns, augments,
deletes or container-mutates a mirrored field on a worker-state object.

Matching is name-based on the attribute base (``ws``/``wws``/``lws``/
``vws``/``worker_state`` — the universal WorkerState binding names in
this codebase — plus ``self`` inside ``class WorkerState`` itself, for
``__init__``/``clean``).  A legitimate new mutation site either moves
into a helper, gets added to the registry here (WITH a mirror mark), or
carries an ``# graft-lint: allow[mirror-parity] reason`` pragma — same
baseline machinery as the other rules.
"""

from __future__ import annotations

import ast
from typing import Iterator

from distributed_tpu_torch.analysis import astutils
from distributed_tpu_torch.analysis.core import Finding, LintContext, Rule, register

#: mirrored WorkerState fields (scheduler/mirror.py FIELDS + the replica
#: container feeding ``nbytes``); ``nprocessing`` mirrors
#: ``len(ws.processing)``, so the processing dict is included
_SCALAR_FIELDS = frozenset({"occupancy", "nthreads", "nbytes", "status"})
_CONTAINER_FIELDS = frozenset({"has_what", "processing"})
#: method calls that mutate a container in place
_MUTATORS = frozenset({
    "add", "discard", "remove", "clear", "pop", "popitem", "update",
    "setdefault", "append", "extend",
})
#: names a scheduler-side WorkerState binding goes by
_WS_NAMES = frozenset({"ws", "wws", "lws", "vws", "worker_state"})

#: the mirror-aware registry: enclosing functions allowed to mutate
#: mirrored fields (each either marks the mirror row or runs before the
#: worker is registered / after it is tombstoned)
_ALLOWED_FUNCS = frozenset({
    "__init__",              # WorkerState construction (idx not assigned yet)
    "clean",                 # detached diagnostics copy, never registered
    "_adjust_occupancy",
    "_exit_processing_common",
    "_add_to_processing",
    "_clear_task_state",
    "add_replica",
    "remove_replica",
    "remove_all_replicas",
    "update_nbytes",
    "add_worker_state",
    "remove_worker_state",
    "set_worker_status",
    "set_worker_nthreads",
})


def _is_worker_base(node: ast.expr, ws_classes: set[str],
                    func_name: str) -> bool:
    """Does ``node`` look like a WorkerState object?"""
    if isinstance(node, ast.Name):
        if node.id in _WS_NAMES:
            return True
        if node.id == "self" and func_name in ws_classes:
            return True
    return False


@register
class MirrorParityRule(Rule):
    name = "mirror-parity"
    description = (
        "mirrored WorkerState fields (occupancy/nthreads/nbytes/status/"
        "has_what/processing) mutate only inside mirror-aware helpers"
    )
    # the mirror's delta sources live in the scheduler package; worker-
    # side state machines keep their own unrelated fields of the same
    # names
    scope = ("distributed_tpu_torch/scheduler/**",)

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        for mod in ctx.modules(self):
            astutils.add_parents(mod.tree)
            # method names defined on WorkerState in this module (so
            # ``self.<field> = ...`` inside them is recognized)
            ws_methods: set[str] = set()
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.ClassDef) and node.name == "WorkerState":
                    for item in node.body:
                        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                            ws_methods.add(item.name)
            for node in ast.walk(mod.tree):
                hit = self._mutation(node, ws_methods)
                if hit is None:
                    continue
                field, kind = hit
                fn = astutils.enclosing_function_name(node)
                if fn.rsplit(".", 1)[-1] in _ALLOWED_FUNCS:
                    continue
                yield Finding(
                    rule=self.name, path=mod.relpath,
                    line=node.lineno, col=node.col_offset,
                    message=(
                        f"{kind} of mirrored field `{field}` outside the "
                        f"mirror-aware helpers — route through "
                        f"SchedulerState (set_worker_status/"
                        f"set_worker_nthreads/_adjust_occupancy/replica "
                        f"model) or mark the mirror row, then register "
                        f"the helper in analysis/rules/mirror_parity.py"
                    ),
                    symbol=fn,
                )

    @staticmethod
    def _mutation(node: ast.AST, ws_methods: set[str]) -> tuple[str, str] | None:
        """(field, kind) when ``node`` mutates a mirrored field."""

        def worker_attr(expr: ast.expr, fields) -> str | None:
            if (
                isinstance(expr, ast.Attribute)
                and expr.attr in fields
                and _is_worker_base(
                    expr.value, ws_methods,
                    astutils.enclosing_function_name(expr).rsplit(".", 1)[-1],
                )
            ):
                return expr.attr
            return None

        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            for tgt in targets:
                # ws.field = ... / ws.field += ...
                f = worker_attr(tgt, _SCALAR_FIELDS | _CONTAINER_FIELDS)
                if f is not None:
                    return f, "assignment"
                # ws.container[...] = ...
                if isinstance(tgt, ast.Subscript):
                    f = worker_attr(tgt.value, _CONTAINER_FIELDS)
                    if f is not None:
                        return f, "item assignment"
        elif isinstance(node, ast.Delete):
            for tgt in node.targets:
                if isinstance(tgt, ast.Subscript):
                    f = worker_attr(tgt.value, _CONTAINER_FIELDS)
                    if f is not None:
                        return f, "item deletion"
        elif isinstance(node, ast.Call):
            func = node.func
            if (
                isinstance(func, ast.Attribute)
                and func.attr in _MUTATORS
            ):
                f = worker_attr(func.value, _CONTAINER_FIELDS)
                if f is not None:
                    return f, f"in-place `{func.attr}`"
        return None


# ------------------------------------------------------------ soa-hydration

#: SoA-backed underscore slots (scheduler/state.py property pairs): the
#: public name drains deferred native segments before every read/write;
#: the underscore slot is the raw storage the drain-first contract
#: protects.  A stray write to the slot bypasses the materialization
#: barrier and silently diverges python truth from the authoritative
#: C++ rows (docs/native_engine.md).
_SOA_TASK_FIELDS = frozenset({
    "_state", "_waiting_on", "_waiters", "_who_has", "_processing_on",
    "_nbytes", "_type", "_metadata", "_homed", "_ledger_row",
})
_SOA_WORKER_FIELDS = frozenset({
    "_nbytes", "_has_what", "_processing", "_long_running", "_occupancy",
})
_SOA_SCHED_FIELDS = frozenset({"_transition_log"})
_SOA_FIELDS = _SOA_TASK_FIELDS | _SOA_WORKER_FIELDS | _SOA_SCHED_FIELDS

#: names TaskState / SchedulerState bindings go by in scheduler code
#: (WorkerState names are shared with the mirror rule above)
_TS_NAMES = frozenset({"ts", "dts", "ts0", "ts1", "ts2", "tts",
                       "task_state"})
_SS_NAMES = frozenset({"s", "state", "sched_state"})

#: the write-back registry: enclosing functions allowed to touch the
#: raw slots.  Construction and the property accessors themselves
#: (named after the field, sans underscore), plus the deferred-replay
#: appliers — the ONLY code that materializes native truth into the
#: slots (NativeEngine.sync / _apply_tape_inner).
_SOA_ALLOWED_FUNCS = frozenset(
    {"__init__", "clean", "sync", "_apply_tape_inner"}
    | {f.lstrip("_") for f in _SOA_FIELDS}
)

#: classes whose ``self`` carries SoA-backed slots
_SOA_CLASSES = ("TaskState", "WorkerState", "SchedulerState")


@register
class SoaHydrationRule(Rule):
    name = "soa-hydration"
    description = (
        "SoA-backed underscore slots (_state/_waiting_on/…/_occupancy/"
        "_transition_log) mutate only inside registered hydration/"
        "write-back helpers — stray writes bypass the deferred-"
        "materialization barrier"
    )
    scope = ("distributed_tpu_torch/scheduler/**",)

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        for mod in ctx.modules(self):
            astutils.add_parents(mod.tree)
            # method names of the slot-carrying classes in this module,
            # so ``self._field`` inside them is recognized
            soa_methods: set[str] = set()
            for node in ast.walk(mod.tree):
                if (
                    isinstance(node, ast.ClassDef)
                    and node.name in _SOA_CLASSES
                ):
                    for item in node.body:
                        if isinstance(
                            item, (ast.FunctionDef, ast.AsyncFunctionDef)
                        ):
                            soa_methods.add(item.name)
            for node in ast.walk(mod.tree):
                hit = self._mutation(node, soa_methods)
                if hit is None:
                    continue
                field, kind = hit
                fn = astutils.enclosing_function_name(node)
                if fn.rsplit(".", 1)[-1] in _SOA_ALLOWED_FUNCS:
                    continue
                yield Finding(
                    rule=self.name, path=mod.relpath,
                    line=node.lineno, col=node.col_offset,
                    message=(
                        f"{kind} of SoA-backed slot `{field}` outside "
                        f"the registered hydration/write-back helpers — "
                        f"use the public property (it drains deferred "
                        f"native segments first) or register the helper "
                        f"in analysis/rules/mirror_parity.py "
                        f"(_SOA_ALLOWED_FUNCS)"
                    ),
                    symbol=fn,
                )

    @staticmethod
    def _mutation(node: ast.AST, soa_methods: set[str]) -> tuple[str, str] | None:
        """(field, kind) when ``node`` writes a SoA-backed slot."""

        def soa_attr(expr: ast.expr) -> str | None:
            if not (
                isinstance(expr, ast.Attribute) and expr.attr in _SOA_FIELDS
            ):
                return None
            base = expr.value
            if isinstance(base, ast.Name):
                if base.id in _TS_NAMES | _WS_NAMES | _SS_NAMES:
                    return expr.attr
                if base.id == "self":
                    fn = astutils.enclosing_function_name(expr)
                    if fn.rsplit(".", 1)[-1] in soa_methods:
                        return expr.attr
            return None

        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            for tgt in targets:
                f = soa_attr(tgt)
                if f is not None:
                    return f, "assignment"
                if isinstance(tgt, ast.Subscript):
                    f = soa_attr(tgt.value)
                    if f is not None:
                        return f, "item assignment"
            # x = ts._waiting_on.add — a bound-mutator alias escapes
            # the write barrier just like a direct call
            if isinstance(node, ast.Assign):
                v = node.value
                if isinstance(v, ast.Attribute) and v.attr in _MUTATORS:
                    f = soa_attr(v.value)
                    if f is not None:
                        return f, f"bound-mutator alias `{v.attr}`"
        elif isinstance(node, ast.Delete):
            for tgt in node.targets:
                if isinstance(tgt, ast.Subscript):
                    f = soa_attr(tgt.value)
                    if f is not None:
                        return f, "item deletion"
        elif isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute) and func.attr in _MUTATORS:
                f = soa_attr(func.value)
                if f is not None:
                    return f, f"in-place `{func.attr}`"
        return None
