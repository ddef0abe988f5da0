"""The port's scheduler-side pieces: the placement plan (``plan.py``)."""
