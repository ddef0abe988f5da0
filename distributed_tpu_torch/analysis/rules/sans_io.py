"""sans-io: the transition engines must stay pure and IO-free.

``scheduler/state.py``, ``worker/state_machine.py``, and ``graph/`` are the
deterministic cores the device co-processor mirrors into tensors and
replays as oracles (PAPER.md).  One ``import asyncio`` or one socket call
and the replay property is gone: device placement decisions could diverge
from host decisions depending on wall-clock/event-loop state.

Flags, anywhere in a scoped file (including function-local imports):

- imports of event-loop / IO / process machinery (``asyncio``, ``socket``,
  ``subprocess``, ``selectors``, ``threading``, ``concurrent.futures``)
  and of this project's IO layers (``distributed_tpu_torch.rpc``,
  ``distributed_tpu_torch.comm``);
- ``async def`` / ``await`` (a sans-IO engine has no coroutines);
- direct file IO via ``open(...)``.
"""

from __future__ import annotations

import ast
from typing import Iterator

from distributed_tpu_torch.analysis import astutils
from distributed_tpu_torch.analysis.core import Finding, LintContext, Rule, register

_BANNED_MODULES = (
    "asyncio",
    "socket",
    "subprocess",
    "selectors",
    "threading",
    "concurrent.futures",
    "distributed_tpu_torch.rpc",
    "distributed_tpu_torch.comm",
)


def _banned(module: str) -> str | None:
    for banned in _BANNED_MODULES:
        if module == banned or module.startswith(banned + "."):
            return banned
    return None


@register
class SansIORule(Rule):
    name = "sans-io"
    description = (
        "transition engines and graph code must not import IO/event-loop "
        "machinery or define coroutines"
    )
    scope = (
        "distributed_tpu_torch/scheduler/state.py",
        "distributed_tpu_torch/worker/state_machine.py",
        "distributed_tpu_torch/graph/*.py",
        # the cluster simulator's determinism IS its product: one
        # socket import or event loop and the same-seed digest contract
        # is gone (docs/simulator.md)
        "distributed_tpu_torch/sim/*.py",
    )

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        for mod in ctx.modules(self):
            astutils.add_parents(mod.tree)
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Import):
                    for alias in node.names:
                        hit = _banned(alias.name)
                        if hit:
                            yield self._finding(
                                mod, node, f"imports {hit!r}"
                            )
                elif isinstance(node, ast.ImportFrom) and node.module:
                    hit = _banned(node.module)
                    if hit:
                        yield self._finding(mod, node, f"imports from {hit!r}")
                elif isinstance(node, (ast.AsyncFunctionDef, ast.Await,
                                       ast.AsyncFor, ast.AsyncWith)):
                    yield self._finding(
                        mod, node,
                        "async/await has no place in a sans-IO engine",
                    )
                elif (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "open"
                ):
                    yield self._finding(mod, node, "performs file IO (open)")

    def _finding(self, mod, node: ast.AST, message: str) -> Finding:
        return Finding(
            rule=self.name, path=mod.relpath, line=node.lineno,
            col=node.col_offset,
            message=f"sans-IO module {message}",
            symbol=astutils.enclosing_function_name(node),
        )
