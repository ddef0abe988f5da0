"""monotonic-time: server/diagnostics code must not read the wall clock.

Every duration in the control plane (heartbeat reconciliation windows,
worker TTLs, idle timeouts, backoff) must come from a monotonic clock —
``distributed_tpu_torch.utils.misc.time`` IS ``time.monotonic`` for exactly this
reason, with ``wall_clock`` as the explicit opt-in for human-facing
timestamps.  An NTP step during ``time.time()``-based bookkeeping evicts
healthy workers or wedges timeouts.  ``time.sleep`` on the event loop is a
stall of every connected worker; async code must ``await asyncio.sleep``.

Flags (alias-aware: ``import time as _t; _t.time()`` still hits):

- ``time.time()`` calls and ``from time import time`` imports;
- ``time.sleep()`` calls and ``from time import sleep`` imports
  (``asyncio.sleep`` in a non-async context is a different bug and is out
  of scope here; blocking-in-async covers sleeps inside coroutines).
"""

from __future__ import annotations

import ast
from typing import Iterator

from distributed_tpu_torch.analysis import astutils
from distributed_tpu_torch.analysis.core import Finding, LintContext, Rule, register

_BANNED_CALLS = {
    "time.time": "wall clock read; use distributed_tpu_torch.utils.misc.time "
                 "(monotonic) or wall_clock if a timestamp is truly wanted",
    "time.sleep": "blocking sleep; use `await asyncio.sleep` on the loop "
                  "or move the wait off-loop",
}


@register
class MonotonicTimeRule(Rule):
    name = "monotonic-time"
    description = (
        "no time.time()/time.sleep() in server or diagnostics code; use "
        "utils.misc.time and asyncio.sleep"
    )
    # everything event-loop-adjacent; ops/ is host-side numerics and
    # utils/misc.py is where the sanctioned aliases live.  tracing.py is
    # in scope by name: flight-recorder timestamps are the causal order
    # of the control loop, so every emission site must stamp with the
    # monotonic utils.misc.time — an NTP step must never reorder a trace
    scope = (
        "distributed_tpu_torch/scheduler/**",
        "distributed_tpu_torch/worker/**",
        "distributed_tpu_torch/rpc/**",
        "distributed_tpu_torch/comm/**",
        "distributed_tpu_torch/client/**",
        "distributed_tpu_torch/diagnostics/**",
        "distributed_tpu_torch/shuffle/**",
        "distributed_tpu_torch/http/**",
        "distributed_tpu_torch/deploy/**",
        "distributed_tpu_torch/coordination/**",
        "distributed_tpu_torch/protocol/**",
        "distributed_tpu_torch/tracing.py",
        # telemetry snapshots/timestamps share the flight recorder's
        # monotonic clock — an NTP step must never skew a bandwidth
        # sample or misalign /telemetry records against /trace
        "distributed_tpu_torch/telemetry.py",
        # the decision ledger's regrets are differences of two stamps
        # on one clock — a wall step between decision and join would
        # fabricate regret out of thin air
        "distributed_tpu_torch/ledger.py",
        # the simulator must never read ANY real clock (virtual time is
        # the determinism contract); the rule bans the wall-clock half,
        # and the sim's own code reads only its VirtualClock
        "distributed_tpu_torch/sim/**",
    )

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        for mod in ctx.modules(self):
            astutils.add_parents(mod.tree)
            imports = mod.imports()
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.ImportFrom):
                    if node.module == "time" and not node.level:
                        for alias in node.names:
                            if alias.name in ("time", "sleep"):
                                yield Finding(
                                    rule=self.name, path=mod.relpath,
                                    line=node.lineno, col=node.col_offset,
                                    message=(
                                        f"imports wall-clock `time.{alias.name}`; "
                                        + _BANNED_CALLS[f"time.{alias.name}"]
                                    ),
                                    symbol=astutils.enclosing_function_name(node),
                                )
                elif isinstance(node, ast.Call):
                    target = imports.resolve(node.func)
                    if target in _BANNED_CALLS:
                        yield Finding(
                            rule=self.name, path=mod.relpath,
                            line=node.lineno, col=node.col_offset,
                            message=f"calls {target}(): {_BANNED_CALLS[target]}",
                            symbol=astutils.enclosing_function_name(node),
                        )
