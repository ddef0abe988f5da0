"""Rule modules self-register on import; import them all here."""

from distributed_tpu_torch.analysis.rules import (  # noqa: F401
    await_atomicity,
    blocking_async,
    config_keys,
    determinism,
    handler_parity,
    launch_sync,
    mirror_parity,
    monotonic_time,
    sans_io,
    state_machine,
    swallowed,
    wire_no_copy,
)
