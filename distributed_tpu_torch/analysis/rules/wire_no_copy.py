"""wire-no-copy: no payload materialization on the comm/protocol hot path.

The zero-copy wire contract (docs/wire.md): frames travel as
memoryviews end to end — the send side hands ``dumps`` frames straight
to the transport, the receive side carves read-only slices of one
pooled buffer, and reassembly/compression work off the buffer protocol.
The two idioms that silently break it are ``bytes(frame)`` (one full
copy per call site, invisible in review) and ``b"".join(...)`` over
frame parts (a copy per part plus the joined copy).  This rule flags
both anywhere in ``comm/`` and ``protocol/``:

- calls of the ``bytes(x)`` constructor with a single non-literal
  argument (conversion, not construction);
- ``.join`` called on a bytes literal.

Justified sites — error-path reprs, RFC-mandated websocket masking,
non-contiguous pickle buffers, the msgpack envelope — carry
``# graft-lint: allow[wire-no-copy] reason`` pragmas or baseline
entries, same machinery as every other rule.  The sanctioned fallback
for gathering scattered parts is ONE preallocated ``bytearray`` filled
by slice assignment (see ``protocol/core._merge_parts``), which this
rule deliberately does not flag.
"""

from __future__ import annotations

import ast
from typing import Iterator

from distributed_tpu_torch.analysis import astutils
from distributed_tpu_torch.analysis.core import Finding, LintContext, Rule, register


@register
class WireNoCopyRule(Rule):
    name = "wire-no-copy"
    description = (
        "no bytes(frame) materialization or b''.join over payload parts "
        "in comm/protocol wire paths; gather into one bytearray instead"
    )
    scope = (
        "distributed_tpu_torch/comm/**",
        "distributed_tpu_torch/protocol/**",
    )

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        for mod in ctx.modules(self):
            astutils.add_parents(mod.tree)
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                msg = self._violation(node)
                if msg is None:
                    continue
                yield Finding(
                    rule=self.name, path=mod.relpath,
                    line=node.lineno, col=node.col_offset,
                    message=msg,
                    symbol=astutils.enclosing_function_name(node),
                )

    @staticmethod
    def _violation(node: ast.Call) -> str | None:
        func = node.func
        # bytes(x) conversion — a full copy of x
        if (
            isinstance(func, ast.Name)
            and func.id == "bytes"
            and len(node.args) == 1
            and not node.keywords
            and not isinstance(node.args[0], ast.Constant)
        ):
            return (
                "bytes(...) materializes a copy on the wire path — pass "
                "the buffer-protocol object through, or gather into one "
                "preallocated bytearray (docs/wire.md)"
            )
        # b"".join(parts) — copy-per-part plus the joined copy
        if (
            isinstance(func, ast.Attribute)
            and func.attr == "join"
            and isinstance(func.value, ast.Constant)
            and isinstance(func.value.value, bytes)
        ):
            return (
                "bytes-join over frame parts copies twice — slice the "
                "contiguous receive buffer or gather into one "
                "preallocated bytearray (docs/wire.md)"
            )
        return None
