"""Diagnostics of the port."""
