"""graft-lint for the PyTorch + CUDA port: the AST checker of
``distributed_tpu/analysis``, pointed at ``distributed_tpu_torch/``.

The port's control plane rests on the reference's contracts:

- the transition engines (``scheduler/state.py``, ``worker/state_machine.py``)
  and the graph layer are **sans-IO** — pure, deterministic state machines
  that the device mirror copies into tensors and the simulator replays;
- event-loop code never blocks and never reads the wall clock;
- RPC/stream senders and handler tables stay in keyword-level agreement
  (a mismatched kwarg is a silent ``TypeError`` swallowed by the stream
  loop);
- the host code that launches a hand-written kernel in ``ops/`` never
  syncs the card (``launch-sync``, the counterpart of the reference's
  ``jit-purity``);
- handler/server code never swallows exceptions silently.

``graft-lint`` enforces those contracts statically, reading each file's
source with :mod:`ast` and importing none of the modules it checks.  Run
it as::

    python -m distributed_tpu_torch.analysis [--format json]

Rules live in :mod:`distributed_tpu_torch.analysis.rules`; scoping lives in
the repo-root ``graft-lint-torch.toml``; intentional violations are
allowlisted in ``graft-lint-torch-baseline.toml`` (every entry needs a
``reason``) or with an inline ``# graft-lint: allow[rule-name] reason``
pragma.
"""

from distributed_tpu_torch.analysis.core import (  # noqa: F401
    Finding,
    LintContext,
    Rule,
    all_rules,
    register,
    run_lint,
)
