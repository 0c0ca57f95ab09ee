"""Int8 error-feedback gradient compression. Counterpart of the
single-process half of ``repro/distributed/collectives.py``.

``compress_gradients`` quantizes and dequantizes each gradient leaf with
error feedback: the update the optimizer sees is exactly what a
compressed data-parallel all-reduce would deliver, and the quantization
error is carried to the next step, not dropped. Trees are nested dicts
of tensors (``repro_torch.tree``). ``compressed_psum``, the all-reduce
itself, needs a process group and waits for the mesh tooling.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map


def quantize_int8(x, err):
    """Error-feedback int8 quantization. Returns (q, scale, new_err):
    the scale is max |x + err| / 127 (at least 1e-12), q rounds half to
    even and clips to [-127, 127], all in float32 as the reference."""
    xf = x.float() + err
    scale = torch.clamp(xf.abs().max() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return q, scale, xf - deq


def dequantize_int8(q, scale):
    return q.float() * scale


def init_error_state(tree):
    """Zeros in float32, one per leaf."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), tree)


def compress_gradients(grads, err_state):
    """(dequantized grads, new error state), leaf by leaf."""
    qs = tree_map(quantize_int8, grads, err_state)   # (q, scale, err) leaves
    return (tree_map(lambda t: dequantize_int8(t[0], t[1]), qs),
            tree_map(lambda t: t[2], qs))
