"""The worker's side of the port: the sans-io state machine, and the
process-group join and setup."""
