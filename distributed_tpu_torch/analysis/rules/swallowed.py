"""swallowed-exceptions: handler/server code may not eat errors silently.

``except Exception: pass`` in the RPC/stream plane turns protocol bugs
into silence — exactly how a keyword mismatch or a half-dead comm goes
unnoticed until a task wedges.  Round 5's race suite found bugs at
runtime that a loud except-path would have surfaced immediately.

Flags ``except Exception:`` / bare ``except:`` handlers whose body is
nothing but ``pass``/``...`` (a handler that logs, re-raises, or mutates
state is fine) in server, RPC, comm, and HTTP code.
"""

from __future__ import annotations

import ast
from typing import Iterator

from distributed_tpu_torch.analysis import astutils
from distributed_tpu_torch.analysis.core import Finding, LintContext, Rule, register


def _is_silent(handler: ast.ExceptHandler) -> bool:
    if len(handler.body) != 1:
        return False
    stmt = handler.body[0]
    if isinstance(stmt, ast.Pass):
        return True
    return (
        isinstance(stmt, ast.Expr)
        and isinstance(stmt.value, ast.Constant)
        and stmt.value.value is Ellipsis
    )


def _is_broad(handler: ast.ExceptHandler) -> bool:
    if handler.type is None:  # bare except:
        return True
    name = astutils.dotted(handler.type)
    return name in ("Exception", "BaseException")


@register
class SwallowedExceptionsRule(Rule):
    name = "swallowed-exceptions"
    description = (
        "no silent `except Exception: pass` in handler/server code — log, "
        "narrow, or allowlist with a reason"
    )
    scope = (
        "distributed_tpu_torch/scheduler/server.py",
        "distributed_tpu_torch/worker/server.py",
        "distributed_tpu_torch/worker/nanny.py",
        "distributed_tpu_torch/rpc/**",
        "distributed_tpu_torch/comm/**",
        "distributed_tpu_torch/http/**",
    )

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        for mod in ctx.modules(self):
            astutils.add_parents(mod.tree)
            for node in ast.walk(mod.tree):
                if (
                    isinstance(node, ast.ExceptHandler)
                    and _is_broad(node)
                    and _is_silent(node)
                ):
                    yield Finding(
                        rule=self.name, path=mod.relpath,
                        line=node.lineno, col=node.col_offset,
                        message=(
                            "broad except swallows the error silently; log "
                            "it, narrow the type, or justify in the baseline"
                        ),
                        symbol=astutils.enclosing_function_name(node),
                    )
