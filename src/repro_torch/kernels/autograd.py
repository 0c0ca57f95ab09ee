"""When a kernel call must have a backward: autograd records a call when
grad mode is on and one of its tensors requires grad. On CUDA tensors
such a call goes through the kernel's ``torch.autograd.Function``
(``flash_attention``, ``rglru_scan``, ``rwkv6_scan``); on CPU tensors
autograd runs through the plain version."""
from __future__ import annotations

import torch


def needs_backward(*tensors) -> bool:
    """Whether autograd records a call on ``tensors`` (None skipped)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)
