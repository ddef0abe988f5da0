"""blocking-in-async: nothing on the event loop may block.

One blocking call inside an ``async def`` stalls the scheduler for every
worker and client at once (or stalls a worker's comm/heartbeat plane).
The codebase's contract is: blocking work happens in a nested ``def``
handed to ``run_in_executor`` — so this rule walks coroutine bodies
WITHOUT descending into nested functions/lambdas (those are executor
targets or callbacks) and flags what remains:

- ``time.sleep(...)`` (alias-aware);
- sync process spawns: ``subprocess.run/call/check_call/check_output``,
  ``os.system``, ``os.popen``;
- sync file IO: ``open(...)`` calls;
- blocking ``<...lock...>.acquire()`` — a ``threading``-style lock taken
  on the loop without ``await`` (receiver name must mention "lock" /
  "sem" to keep this heuristic honest).
"""

from __future__ import annotations

import ast
from typing import Iterator

from distributed_tpu_torch.analysis import astutils
from distributed_tpu_torch.analysis.core import Finding, LintContext, Rule, register

_BLOCKING_CALLS = {
    "time.sleep": "use `await asyncio.sleep(...)`",
    "subprocess.run": "use asyncio.create_subprocess_exec or an executor",
    "subprocess.call": "use asyncio.create_subprocess_exec or an executor",
    "subprocess.check_call": "use asyncio.create_subprocess_exec or an executor",
    "subprocess.check_output": "use asyncio.create_subprocess_exec or an executor",
    "os.system": "use asyncio.create_subprocess_exec or an executor",
    "os.popen": "use asyncio.create_subprocess_exec or an executor",
}


def _lockish(node: ast.AST) -> bool:
    name = astutils.dotted(node) or ""
    tail = name.lower().rsplit(".", 1)[-1]
    return "lock" in tail or "sem" in tail


@register
class BlockingInAsyncRule(Rule):
    name = "blocking-in-async"
    description = (
        "no sync sleep/file-IO/subprocess/lock.acquire directly inside "
        "async def bodies (executor-target nested defs are exempt)"
    )
    scope = ("distributed_tpu_torch/**",)

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        for mod in ctx.modules(self):
            astutils.add_parents(mod.tree)
            imports = mod.imports()
            for fn in ast.walk(mod.tree):
                if not isinstance(fn, ast.AsyncFunctionDef):
                    continue
                for node in astutils.walk_scope(fn):
                    if not isinstance(node, ast.Call):
                        continue
                    target = imports.resolve(node.func)
                    msg = None
                    if target in _BLOCKING_CALLS:
                        msg = f"calls {target}(): {_BLOCKING_CALLS[target]}"
                    elif isinstance(node.func, ast.Name) and node.func.id == "open":
                        msg = (
                            "sync file IO on the event loop; move it into "
                            "an executor-submitted function"
                        )
                    elif (
                        isinstance(node.func, ast.Attribute)
                        and node.func.attr == "acquire"
                        and _lockish(node.func.value)
                        and not isinstance(
                            astutils.parent(node), ast.Await
                        )
                    ):
                        msg = (
                            "blocking lock.acquire() on the event loop; use "
                            "an asyncio lock (awaited) or an executor"
                        )
                    if msg:
                        yield Finding(
                            rule=self.name, path=mod.relpath,
                            line=node.lineno, col=node.col_offset,
                            message=msg, symbol=fn.name,
                        )
