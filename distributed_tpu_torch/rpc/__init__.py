"""The port's RPC layer: so far only ``PeriodicCallback``."""
