"""Whole-program models extracted from the AST (no imports of the code
they describe).  Today: the task state machines (model/state_machine.py),
consumed by the ``state-machine`` lint rule, serialized to JSON + DOT for
docs/state_machine/, and available to future device kernels that need the
transition graph as data."""

from distributed_tpu_torch.analysis.model.state_machine import (  # noqa: F401
    Emission,
    Machine,
    extract_machines,
    machine_to_dot,
    machine_to_json,
)
