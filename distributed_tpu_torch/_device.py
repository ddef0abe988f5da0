"""The port's device rule: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device; only an explicit CPU device
    runs on the CPU.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or
    by default) and ``torch.cuda.is_available()`` is false, so no path
    quietly continues on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; distributed_tpu_torch runs on "
            "the GPU by default — pass device='cpu' to run the plain "
            "PyTorch versions of its kernels"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
