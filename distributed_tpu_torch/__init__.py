"""PyTorch + CUDA port of ``distributed_tpu`` for NVIDIA Hopper: its device
paths, and the sans-io control plane that drives them (the scheduler
engine, the worker state machine and the simulator).

The JAX package stays the reference; this package sits beside it, keeps
the reference's module names (``ops/leveled.py``, ``ops/flash.py``) and
imports nothing from it.  Every entry point takes ``device=None``, which
means the CUDA device and raises when none is present; only an explicit
``device="cpu"`` runs the plain PyTorch versions of the kernels.

Hand-written kernels live under ``ops/csrc`` and are built with ``nvcc``
at first use (``ops/_build.py``).
"""

from distributed_tpu_torch._device import resolve_device

__version__ = "0.1.0"

__all__ = ["__version__", "resolve_device"]
