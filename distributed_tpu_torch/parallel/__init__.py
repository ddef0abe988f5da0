"""Multi-process bring-up of the port's device plane (``multihost.py``)."""
