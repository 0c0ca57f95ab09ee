"""Where the port runs: the card unless the caller asks for the CPU.

Every entry point takes a ``device`` argument that defaults to
``"cuda"``. On a machine without CUDA that default raises; it never
carries on on the CPU. Tests pass ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    CUDA device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch finds no CUDA "
            "device; pass device='cpu' to run on the CPU")
    return dev
