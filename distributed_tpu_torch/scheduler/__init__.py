"""The port's scheduler side: the sans-io engine (``state.py``), the
placement extension and its plan, the fleet mirror and the periodic
extensions with their device paths."""
