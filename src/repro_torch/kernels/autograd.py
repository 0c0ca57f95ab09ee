"""When a kernel call must have a backward: autograd records a call when
grad mode is on and one of its tensors requires grad. A wrapper whose
kernel has no backward yet raises on such a CUDA call, naming itself,
instead of returning a tensor that silently ends the graph (its plain
version on CPU tensors is differentiable and stays the CPU route)."""
from __future__ import annotations

import torch


def needs_backward(*tensors) -> bool:
    """Whether autograd records a call on ``tensors`` (None skipped)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_backward(name: str, *tensors) -> None:
    """Raise if autograd would record this call: ``name``'s kernel has no
    backward."""
    if needs_backward(*tensors):
        raise NotImplementedError(
            f"{name} has no backward kernel yet: a training step on the "
            "card cannot run through it (train on the CPU, or run the "
            "forward under torch.no_grad or torch.inference_mode)")
