"""state-machine: the transition tables and every emission must agree.

Hand-found bugs have come from the interplay between the two
stringly-typed task state machines and the code that drives them; the
tables are the contract every co-processor kernel assumes.  This
whole-program rule extracts the full model (analysis/model/) and flags:

1. **unresolvable emissions** — an emitted ``(start, finish)`` pair
   (start proven by an enclosing ``.state == ...`` guard) with no
   registered transition, directly or via the engines' through-
   "released" fallback, and emissions of states no table knows;
2. **unreachable transitions** — table edges no emission or stimulus can
   trigger, and ``_transition_*`` handler defs neither registered in a
   table nor called directly (dead weight that silently rots);
3. **batch/oracle drift** — a ``stimulus_*_batch`` / ``transitions_batch``
   arm whose reachable transition surface (finish states + stimulus
   helpers) differs from its scalar oracle's: the batch engine's whole
   contract is bit-parity with N scalar calls.
"""

from __future__ import annotations

import ast
from typing import Iterator

from distributed_tpu_torch.analysis.core import Finding, LintContext, Rule, register
from distributed_tpu_torch.analysis.model.state_machine import (
    batch_arm_pairs,
    extract_machines,
    reachable_set,
)

#: the module that declares the native engine's compiled arm set
_NATIVE_BRIDGE = "distributed_tpu_torch/scheduler/native_engine.py"


def _compiled_arms(tree: ast.AST) -> tuple[int, list[tuple[str, str]]]:
    """The (line, pairs) of the COMPILED_ARMS literal in the native
    bridge; (0, []) when absent."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        if not any(
            isinstance(t, ast.Name) and t.id == "COMPILED_ARMS"
            for t in node.targets
        ):
            continue
        pairs: list[tuple[str, str]] = []
        if isinstance(node.value, (ast.Tuple, ast.List)):
            for el in node.value.elts:
                if (
                    isinstance(el, (ast.Tuple, ast.List))
                    and len(el.elts) == 2
                    and all(
                        isinstance(x, ast.Constant)
                        and isinstance(x.value, str)
                        for x in el.elts
                    )
                ):
                    pairs.append(
                        (el.elts[0].value, el.elts[1].value)  # type: ignore
                    )
        return node.lineno, pairs
    return 0, []


@register
class StateMachineRule(Rule):
    name = "state-machine"
    description = (
        "every emitted (start, finish) pair resolves to a registered "
        "transition, no table edge or handler is unreachable, and batch "
        "engine arms match their scalar oracles"
    )
    scope = ("distributed_tpu_torch/**",)

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        modules = ctx.modules(self)
        machines = extract_machines(modules)
        mods_by_path = {m.relpath: m for m in modules}

        # ---- 4. the native engine's compiled arm set must be a subset
        # of the extracted SCHEDULER table: a new arm added (or renamed)
        # in python but silently missing from the C++ core shows up as
        # a finding here, not as an escape-rate perf cliff in prod
        bridge = mods_by_path.get(_NATIVE_BRIDGE)
        sched_machine = next(
            (m for m in machines if "scheduler" in m.module), None
        )
        if bridge is not None and sched_machine is not None:
            line, arms = _compiled_arms(bridge.tree)
            if not arms:
                yield Finding(
                    rule=self.name,
                    path=_NATIVE_BRIDGE,
                    line=line or 1,
                    col=0,
                    symbol="COMPILED_ARMS",
                    message=(
                        "native bridge declares no COMPILED_ARMS "
                        "literal; the compiled-arm/table subset check "
                        "cannot run"
                    ),
                )
            table_pairs = {
                (t.start, t.finish) for t in sched_machine.transitions
            }
            for pair in arms:
                if pair not in table_pairs:
                    yield Finding(
                        rule=self.name,
                        path=_NATIVE_BRIDGE,
                        line=line,
                        col=0,
                        symbol="COMPILED_ARMS",
                        message=(
                            f"compiled arm {pair!r} is not an edge of "
                            f"the extracted {sched_machine.name} "
                            "transition table — the C++ core and "
                            "state.py have drifted"
                        ),
                    )

        for machine in machines:
            table = machine.table
            # ---- 1. emissions that resolve to nothing
            for em in machine.emissions:
                if em.resolution in ("unknown-state", "unknown-pair"):
                    yield Finding(
                        rule=self.name,
                        path=em.module,
                        line=em.line,
                        col=em.col,
                        symbol=em.function,
                        message=(
                            f"emission of {em.finish!r} does not resolve "
                            f"against the {machine.name} table: {em.detail}"
                        ),
                    )

            # ---- 2a. table edges nothing can trigger
            reachable = machine.reachable_edges()
            registered_handlers = {t.handler for t in machine.transitions}
            for t in machine.transitions:
                if (t.start, t.finish) in reachable:
                    continue
                if t.handler in machine.handler_calls:
                    continue  # invoked directly (engine fallback, reuse)
                yield Finding(
                    rule=self.name,
                    path=machine.module,
                    line=t.line,
                    col=0,
                    symbol=t.handler,
                    message=(
                        f"transition ({t.start}, {t.finish}) -> {t.handler} "
                        "is unreachable: no emission or stimulus produces "
                        f"{t.finish!r} from {t.start!r}"
                    ),
                )

            # ---- 2b. handler defs neither registered nor called
            for handler, line in sorted(machine.handler_defs.items()):
                if handler in registered_handlers:
                    continue
                if handler in machine.handler_calls:
                    continue
                yield Finding(
                    rule=self.name,
                    path=machine.module,
                    line=line,
                    col=0,
                    symbol=handler,
                    message=(
                        f"transition handler {handler} is registered in no "
                        "table and called from nowhere"
                    ),
                )

            # ---- 3. batch arms vs their scalar oracles
            mod = mods_by_path.get(machine.module)
            if mod is None:
                continue
            for batch_fn, oracle_fn in batch_arm_pairs(mod.tree):
                if not oracle_fn:
                    yield Finding(
                        rule=self.name,
                        path=machine.module,
                        line=machine.table_line,
                        col=0,
                        symbol=batch_fn,
                        message=(
                            f"batch arm {batch_fn} has no scalar oracle "
                            "(expected the _batch-stripped name)"
                        ),
                    )
                    continue
                b_fin, b_help = reachable_set(mod.tree, batch_fn)
                s_fin, s_help = reachable_set(mod.tree, oracle_fn)
                if b_fin != s_fin or b_help != s_help:
                    delta = []
                    if b_fin != s_fin:
                        delta.append(
                            f"finishes batch={sorted(b_fin)} "
                            f"oracle={sorted(s_fin)}"
                        )
                    if b_help != s_help:
                        delta.append(
                            f"helpers batch={sorted(b_help)} "
                            f"oracle={sorted(s_help)}"
                        )
                    yield Finding(
                        rule=self.name,
                        path=machine.module,
                        line=machine.table_line,
                        col=0,
                        symbol=batch_fn,
                        message=(
                            f"batch arm {batch_fn} reaches a different "
                            f"transition surface than oracle {oracle_fn}: "
                            + "; ".join(delta)
                        ),
                    )
