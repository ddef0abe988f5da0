"""The device-resident shuffle (``device.py``)."""
