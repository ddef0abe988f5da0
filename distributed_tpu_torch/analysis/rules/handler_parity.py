"""handler-parity: RPC/stream senders must agree with the handler tables.

The dispatch planes are stringly typed: a request ``{"op": ...}`` is looked
up in ``Server.handlers`` / ``Server.stream_handlers`` and invoked as
``handler(**msg)``.  An op nobody registered is an error reply (RPC) or a
logged-and-dropped message (stream); a keyword the handler doesn't accept
is a ``TypeError`` that the stream loop swallows into a log line while the
task it carried wedges.  Both are invisible until a cluster hangs — and
both are fully decidable from the AST.

This whole-program rule:

1. extracts every handler table in the package — ``handlers = {...}`` /
   ``stream_handlers = {...}`` dict literals, later ``X.handlers["op"] =``
   subscript registrations and ``X.handlers.update({...})`` bulk
   registrations (extensions included), and manual dispatch arms
   (``op == "literal"`` / ``msg.get("op") == "literal"`` comparisons,
   which also teaches it the protocol-internal ops like ``close-stream``);
2. resolves each handler to its def in the same module for keyword
   checking (``self`` and the comm-injected first ``comm`` param are
   dropped; ``lambda **kw`` accepts everything);
3. walks every rpc-proxy call ``<...rpc(...)>.op(key=...)`` and every
   literal message ``{"op": "name", key: ...}`` in the package and flags
   ops with no handler anywhere, and keyword sets that **no** registered
   handler for that op accepts;
4. holds the batch dispatch plane to its scalar oracle: every op
   registered in ``stream_batch_handlers`` (the same-op folds in
   rpc/core.py handle_stream) must also have a scalar stream handler,
   every payload key the batch handler consumes (``m.pop("k")`` /
   ``m.get("k")``) must be accepted by that scalar handler, and every
   explicit scalar payload param must be consumed (or carried through a
   residual dict) by the batch arm — so the two planes cannot drift;
5. trace parity: every op on the batched plane must stamp the flight
   recorder's ingress hop on BOTH planes — the batch arm and its scalar
   twin each emit an ingress trace event (a ``*trace_ingress(...)``
   helper call, or ``<...>.trace.emit("ingress", ...)``; a batch arm
   that wholesale-delegates to an emitting scalar handler counts).  An
   op that skips the hop is invisible to causal stimulus tracing — the
   exact blind spot the recorder exists to remove (tracing.py,
   docs/observability.md).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Iterator

from distributed_tpu_torch.analysis import astutils
from distributed_tpu_torch.analysis.core import Finding, LintContext, Rule, register

#: protocol-level keys stripped by the server before dispatch
_PROTOCOL_KEYS = {"op", "reply", "serializers"}
#: stream-context keys injected by handle_stream's ``extra`` (sender
#: address), present on both planes without appearing in messages
_STREAM_EXTRA_KEYS = {"worker", "client"}
#: attrs that exist on the rpc proxy objects themselves — not ops
_PROXY_ATTRS = {"send_recv", "close_rpc", "live_comm", "address", "comms",
                "pool", "status", "timeout"}


@dataclass
class HandlerInfo:
    op: str
    table: str  # "handlers" | "stream_handlers" | "dispatch"
    module: str
    params: frozenset[str] | None  # None: unresolvable -> accepts anything
    var_kwargs: bool = True

    def accepts(self, keys: set[str]) -> bool:
        if self.params is None or self.var_kwargs:
            return True
        return keys <= self.params


def _table_name(target: ast.AST) -> str | None:
    """'handlers'/'stream_handlers'/'stream_batch_handlers' if target is
    such a table reference."""
    name = astutils.dotted(target)
    if name is None:
        return None
    tail = name.rsplit(".", 1)[-1]
    if tail in ("handlers", "stream_handlers", "stream_batch_handlers"):
        return tail
    return None


def _resolve_params(
    handler_expr: ast.AST, defs: dict[str, list[ast.AST]]
) -> tuple[frozenset[str] | None, bool]:
    if isinstance(handler_expr, ast.Lambda):
        a = handler_expr.args
        names = {p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)}
        return frozenset(names), a.kwarg is not None
    name = astutils.dotted(handler_expr)
    if name is None:
        return None, True
    fn_name = name.rsplit(".", 1)[-1]
    candidates = defs.get(fn_name, [])
    if len(candidates) != 1:
        return None, True
    fn = candidates[0]
    params, var_kw = astutils.func_params(fn)  # type: ignore[arg-type]
    params = set(params)
    params.discard("self")
    # first param 'comm' is injected by the server, never sent
    a = fn.args  # type: ignore[union-attr]
    ordered = [*a.posonlyargs, *a.args]
    if ordered and ordered[0].arg == "self":
        ordered = ordered[1:]
    if ordered and ordered[0].arg == "comm":
        params.discard("comm")
    return frozenset(params), var_kw


def _batch_consumed_keys(fn: ast.AST) -> tuple[set[str], bool]:
    """(payload keys a batch arm reads off its message dicts, does it
    carry a residual dict through).  Keys are the constant strings of
    ``m.pop("k")`` / ``m.get("k")`` on bare-name receivers inside the
    def; ``residual`` is True when such a receiver is also used whole
    (``finishes.append((key, w, sid, m))``) — the un-popped remainder
    travels on, so unknown keys are preserved, not dropped."""
    keys: set[str] = set()
    msg_vars: set[str] = set()
    consuming_attrs: list[ast.Attribute] = []
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in ("pop", "get")
            and isinstance(node.func.value, ast.Name)
            and node.args
        ):
            key = astutils.const_str(node.args[0])
            if key is not None:
                keys.add(key)
                msg_vars.add(node.func.value.id)
                consuming_attrs.append(node.func)
    if not msg_vars:
        # no keyed reads at all: the arm forwards its messages wholesale
        # (``self.handle(**m)``, iteration) — nothing provably drops
        return keys, True
    residual = False
    consuming_attr_ids = {id(a) for a in consuming_attrs}
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.Name)
            and node.id in msg_vars
            and isinstance(node.ctx, ast.Load)
        ):
            parent = astutils.parent(node)
            # any use that is not the receiver of one of the counted
            # pop/get calls — ``(key, w, m)`` tuples, ``**m``, ``m.items()``
            # — carries the un-popped remainder through
            if (
                isinstance(parent, ast.Attribute)
                and id(parent) in consuming_attr_ids
            ):
                continue
            residual = True
            break
    return keys, residual


def _emits_ingress_trace(fn: ast.AST, scalar_names: frozenset[str] = frozenset()) -> bool:
    """Does this handler def stamp the flight recorder's ingress hop?

    True for a call whose dotted tail is ``trace_ingress`` /
    ``_trace_ingress`` (the designated helper), for a direct
    ``<...>.trace.emit("ingress", ...)`` / ``<...>.trace.emit_task(
    "ingress", ...)``, or — batch arms only — for a wholesale delegation
    to a scalar handler in ``scalar_names`` (the scalar's own emission
    then covers the batch plane transitively)."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        name = astutils.dotted(node.func) or ""
        tail = name.rsplit(".", 1)[-1]
        if tail in ("trace_ingress", "_trace_ingress"):
            return True
        if (
            tail in ("emit", "emit_task")
            and (".trace" in f".{name}" or name.startswith("trace."))
            and node.args
            and astutils.const_str(node.args[0]) == "ingress"
        ):
            return True
        if tail in scalar_names:
            return True
    return False


def _is_op_lookup(node: ast.AST) -> bool:
    """``op`` variable or ``<msg>.get("op")`` — a dispatch-arm subject."""
    if isinstance(node, ast.Name) and node.id == "op":
        return True
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr in ("get", "pop")
        and bool(node.args)
        and astutils.const_str(node.args[0]) == "op"
    )


def _is_rpcish(base: ast.AST, relpath: str) -> bool:
    """Does ``base.attr(...)`` look like an rpc-proxy op call?"""
    if isinstance(base, ast.Call):
        name = astutils.dotted(base.func) or ""
        return name == "rpc" or name.endswith(".rpc")
    name = astutils.dotted(base) or ""
    # Client.scheduler is an `rpc` instance (client/client.py)
    return name.endswith(".scheduler") and relpath.endswith("client/client.py")


@register
class HandlerParityRule(Rule):
    name = "handler-parity"
    description = (
        "every rpc/stream op sent must have a registered handler, and its "
        "keywords must be accepted by at least one such handler"
    )
    scope = ("distributed_tpu_torch/**",)

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        modules = ctx.modules(self)
        for mod in modules:
            astutils.add_parents(mod.tree)

        # ---------------------------------------- pass 1: handler tables
        registry: dict[str, list[HandlerInfo]] = {}
        # (op, mod, defs, handler_expr, line) per stream_batch_handlers
        # registration, for the batch/scalar parity pass
        batch_regs: list[tuple] = []
        # op -> [(mod, defs, handler_expr, line)] per stream_handlers
        # registration, for the trace-parity pass (resolving the scalar
        # twin's def, not just its params)
        stream_regs: dict[str, list[tuple]] = {}

        def add(op: str, table: str, module: str, params, var_kw) -> None:
            registry.setdefault(op, []).append(
                HandlerInfo(op, table, module, params, var_kw)
            )

        for mod in modules:
            defs: dict[str, list[ast.AST]] = {}
            for node in ast.walk(mod.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    defs.setdefault(node.name, []).append(node)
            for node in ast.walk(mod.tree):
                if isinstance(node, (ast.Assign, ast.AnnAssign)):
                    # annotated table literals too: ``self.handlers:
                    # dict[str, Callable] = {...}`` registers ops the
                    # same as a bare assignment
                    targets = (
                        node.targets
                        if isinstance(node, ast.Assign)
                        else [node.target]
                    )
                    if node.value is None:
                        continue
                    for target in targets:
                        table = _table_name(target)
                        if table and isinstance(node.value, ast.Dict):
                            for k, v in zip(node.value.keys, node.value.values):
                                op = astutils.const_str(k) if k else None
                                if op:
                                    params, var_kw = _resolve_params(v, defs)
                                    add(op, table, mod.relpath, params, var_kw)
                                    if table == "stream_batch_handlers":
                                        batch_regs.append(
                                            (op, mod, defs, v, node.lineno)
                                        )
                                    elif table == "stream_handlers":
                                        stream_regs.setdefault(op, []).append(
                                            (mod, defs, v, node.lineno)
                                        )
                        elif (
                            isinstance(target, ast.Subscript)
                            and _table_name(target.value)
                        ):
                            op = astutils.const_str(target.slice)
                            if op:
                                table = _table_name(target.value)
                                params, var_kw = _resolve_params(node.value, defs)
                                add(op, table,  # type: ignore[arg-type]
                                    mod.relpath, params, var_kw)
                                if table == "stream_batch_handlers":
                                    batch_regs.append(
                                        (op, mod, defs, node.value,
                                         node.lineno)
                                    )
                                elif table == "stream_handlers":
                                    stream_regs.setdefault(op, []).append(
                                        (mod, defs, node.value, node.lineno)
                                    )
                elif isinstance(node, ast.Call):
                    # bulk registration: X.handlers.update({...})
                    if (
                        isinstance(node.func, ast.Attribute)
                        and node.func.attr == "update"
                        and _table_name(node.func.value)
                        and node.args
                        and isinstance(node.args[0], ast.Dict)
                    ):
                        table = _table_name(node.func.value)
                        for k, v in zip(node.args[0].keys,
                                        node.args[0].values):
                            op = astutils.const_str(k) if k else None
                            if op:
                                params, var_kw = _resolve_params(v, defs)
                                add(op, table, mod.relpath, params, var_kw)  # type: ignore[arg-type]
                                if table == "stream_batch_handlers":
                                    batch_regs.append(
                                        (op, mod, defs, v, node.lineno)
                                    )
                                elif table == "stream_handlers":
                                    stream_regs.setdefault(op, []).append(
                                        (mod, defs, v, node.lineno)
                                    )
                elif isinstance(node, ast.Compare):
                    # manual dispatch: `op == "literal"` / `op in (...)` /
                    # `msg.get("op") ==/!= "literal"`
                    if _is_op_lookup(node.left):
                        for comparator in node.comparators:
                            op = astutils.const_str(comparator)
                            if op:
                                add(op, "dispatch", mod.relpath, None, True)
                            elif isinstance(comparator, (ast.Tuple, ast.List)):
                                for elt in comparator.elts:
                                    op = astutils.const_str(elt)
                                    if op:
                                        add(op, "dispatch", mod.relpath,
                                            None, True)

        # ------------------------------------------ pass 2: call sites
        for mod in modules:
            for node in astutils.iter_calls(mod.tree):
                if not isinstance(node.func, ast.Attribute):
                    continue
                if node.func.attr in _PROXY_ATTRS:
                    continue
                if not _is_rpcish(node.func.value, mod.relpath):
                    continue
                op = node.func.attr
                symbol = astutils.enclosing_function_name(node)
                handlers = registry.get(op)
                if not handlers:
                    yield Finding(
                        rule=self.name, path=mod.relpath, line=node.lineno,
                        col=node.col_offset, symbol=symbol,
                        message=f"rpc call to op {op!r}: no server registers "
                                "this handler",
                    )
                    continue
                keywords, has_star = astutils.call_keywords(node)
                if has_star:
                    continue
                keys = set(keywords) - _PROTOCOL_KEYS
                if not any(h.accepts(keys) for h in handlers):
                    yield self._kw_finding(mod, node, symbol, op, keys, handlers)

            # literal {"op": ...} messages
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Dict):
                    continue
                op = None
                keys: set[str] = set()
                dynamic = False
                for k, _v in zip(node.keys, node.values):
                    ks = astutils.const_str(k) if k is not None else None
                    if ks is None:
                        dynamic = True  # **spread or computed key
                        continue
                    keys.add(ks)
                    if ks == "op":
                        op = astutils.const_str(
                            node.values[node.keys.index(k)]
                        )
                if "op" not in keys or op is None:
                    continue
                symbol = astutils.enclosing_function_name(node)
                handlers = registry.get(op)
                if not handlers:
                    yield Finding(
                        rule=self.name, path=mod.relpath, line=node.lineno,
                        col=node.col_offset, symbol=symbol,
                        message=f"message with op {op!r}: no handler table "
                                "or dispatch arm handles it",
                    )
                    continue
                if dynamic:
                    continue
                msg_keys = keys - _PROTOCOL_KEYS
                if not any(h.accepts(msg_keys) for h in handlers):
                    yield self._kw_finding(mod, node, symbol, op, msg_keys,
                                           handlers)

        # ------------------------- pass 3: batch arms vs scalar oracles
        for op, mod, defs, handler_expr, line in batch_regs:
            name = (astutils.dotted(handler_expr) or "").rsplit(".", 1)[-1]
            scalars = [
                h for h in registry.get(op, ())
                if h.table == "stream_handlers"
            ]
            if not scalars:
                yield Finding(
                    rule=self.name, path=mod.relpath, line=line, col=0,
                    symbol=name or op,
                    message=(
                        f"stream_batch_handlers[{op!r}] has no scalar "
                        "stream handler: lone messages and direct calls "
                        "would hit the unknown-op path"
                    ),
                )
                continue
            candidates = defs.get(name, [])
            if len(candidates) != 1:
                continue  # unresolvable def: nothing further to check
            fn = candidates[0]
            consumed, residual = _batch_consumed_keys(fn)
            consumed -= _PROTOCOL_KEYS
            orphan = sorted(
                k for k in consumed if not any(h.accepts({k}) for h in scalars)
            )
            if orphan:
                yield Finding(
                    rule=self.name, path=mod.relpath, line=fn.lineno, col=0,
                    symbol=name,
                    message=(
                        f"batch arm for op {op!r} consumes payload keys "
                        f"({', '.join(orphan)}) that no scalar stream "
                        "handler for the op accepts"
                    ),
                )
            if not residual:
                # without a carried-through residual dict, every explicit
                # scalar payload param must be consumed explicitly or the
                # batch plane silently drops that field
                dropped = sorted(
                    {
                        p
                        for h in scalars
                        if h.params is not None
                        for p in h.params
                    }
                    - consumed
                    - _PROTOCOL_KEYS
                    - _STREAM_EXTRA_KEYS
                )
                if dropped:
                    yield Finding(
                        rule=self.name, path=mod.relpath, line=fn.lineno,
                        col=0, symbol=name,
                        message=(
                            f"batch arm for op {op!r} neither consumes nor "
                            "carries through payload keys the scalar "
                            f"handler accepts ({', '.join(dropped)})"
                        ),
                    )

        # --------------------- pass 5: trace parity (ingress emission)
        # Every batched-plane op must stamp the flight recorder's
        # ingress hop on BOTH planes (tracing.py); ops without a scalar
        # twin were already flagged by pass 3 and are skipped here.
        for op, mod, defs, handler_expr, line in batch_regs:
            scalars = stream_regs.get(op, ())
            if not scalars:
                continue
            scalar_names = frozenset(
                (astutils.dotted(expr) or "").rsplit(".", 1)[-1]
                for _smod, _sdefs, expr, _line in scalars
            ) - {""}
            name = (astutils.dotted(handler_expr) or "").rsplit(".", 1)[-1]
            candidates = defs.get(name, [])
            if len(candidates) == 1 and not _emits_ingress_trace(
                candidates[0], scalar_names
            ):
                yield Finding(
                    rule=self.name, path=mod.relpath,
                    line=candidates[0].lineno, col=0, symbol=name,
                    message=(
                        f"batch arm for op {op!r} emits no ingress trace "
                        "event (call trace_ingress(...) or "
                        '<...>.trace.emit("ingress", ...)): the flood is '
                        "invisible to causal stimulus tracing"
                    ),
                )
            for smod, sdefs, expr, sline in scalars:
                sname = (astutils.dotted(expr) or "").rsplit(".", 1)[-1]
                scands = sdefs.get(sname, [])
                if len(scands) == 1 and not _emits_ingress_trace(scands[0]):
                    yield Finding(
                        rule=self.name, path=smod.relpath,
                        line=scands[0].lineno, col=0, symbol=sname,
                        message=(
                            f"scalar twin of batched op {op!r} emits no "
                            "ingress trace event: lone messages would "
                            "vanish from causal stimulus tracing"
                        ),
                    )

    def _kw_finding(self, mod, node, symbol, op, keys, handlers) -> Finding:
        details = "; ".join(
            f"{h.module}:{h.table} takes ({', '.join(sorted(h.params or ()))})"
            for h in handlers
            if h.params is not None and not h.var_kwargs
        )
        return Finding(
            rule=self.name, path=mod.relpath, line=node.lineno,
            col=node.col_offset, symbol=symbol,
            message=(
                f"op {op!r} sent with keywords ({', '.join(sorted(keys))}) "
                f"that no registered handler accepts — {details or 'n/a'}"
            ),
        )
