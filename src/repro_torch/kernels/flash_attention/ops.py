"""Public wrapper of the ``flash_attention`` kernel. Counterpart of
``repro/kernels/flash_attention/ops.py``.

For tensors on the CPU it returns the plain PyTorch version
(``ref.py``). For CUDA tensors it launches the hand-written kernel
(``kernel.py``) or raises: there is no fallback. Unlike the TPU wrapper
it pads nothing; the kernel masks ragged Sq and Skv itself. bfloat16
runs on the tensor cores with 16-byte copies, so its tensors must be
16-byte aligned with strides in 16-byte steps; a tensor that is not
raises, it never takes a slower path.
``flash_attention.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_ref

DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k, v, window):
    for name, t in dict(q=q, k=k, v=v).items():
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError("flash_attention: q, k and v must share one "
                            "dtype, float32 or bfloat16; got "
                            f"{q.dtype}, {k.dtype}, {v.dtype}")
        if t.ndim != 4 or t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} must be 4-d with a "
                             "contiguous head dim")
    B, Sq, Hq, hd = q.shape
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd
            or k.shape[2] == 0 or Hq % k.shape[2]):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)} do not fit")
    if hd % 8 or not 0 < hd <= 256:
        raise ValueError(f"flash_attention: head dim {hd} is not a "
                         "multiple of 8 up to 256")
    if window < 0 or (window and Sq - k.shape[1] >= window):
        raise ValueError(f"flash_attention: window {window} leaves q rows "
                         f"with no key (Sq {Sq}, Skv {k.shape[1]})")
    if B > 65535 or Hq > 65535:
        raise ValueError("flash_attention: batch and heads must each be "
                         "at most 65535")
    if q.dtype == torch.bfloat16:
        for name, t in dict(q=q, k=k, v=v).items():
            if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
                raise ValueError(f"flash_attention: bfloat16 {name} must "
                                 "be 16-byte aligned with strides in "
                                 "16-byte steps")


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """q (B,Sq,Hq,hd); k, v (B,Skv,Hkv,hd) -> (B,Sq,Hq,hd) in q's dtype."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or the CPU, not "
                         f"{q.device}")
    _check(q, k, v, window)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    kernel.launch(q, k, v, out, causal, window)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
