"""Public wrapper of the ``rglru_scan`` kernel. Counterpart of
``repro/kernels/rglru_scan/ops.py``.

For tensors on the CPU it returns the plain PyTorch version
(``ref.py``). For CUDA tensors it launches the hand-written kernel
(``kernel.py``) or raises: there is no fallback. Unlike the TPU wrapper
it pads nothing; the kernel walks any S and masks ragged R itself.
``h_out``, when given, receives ``h_last`` (it may be ``h0`` itself, so
a recurrent state is updated in place). ``rglru_scan.launches`` counts
the kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rglru_scan import kernel
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

DTYPES = (torch.float32, torch.bfloat16)


def _check(a, b, h0, h_out):
    for name, t in dict(b=b, h0=h0, h_out=h_out).items():
        if t is not None and t.device != a.device:
            raise ValueError(f"rglru_scan: {name} is on {t.device}, a on "
                             f"{a.device}")
    if a.dtype != b.dtype or a.dtype not in DTYPES:
        raise TypeError("rglru_scan: a and b must share one dtype, float32 "
                        f"or bfloat16; got {a.dtype}, {b.dtype}")
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must be one (B,S,R) shape")
    if a.stride(-1) != 1 or b.stride(-1) != 1:
        raise ValueError("rglru_scan: a and b must have a contiguous "
                         "channel dim")
    B, _, R = a.shape
    for name, t in dict(h0=h0, h_out=h_out).items():
        if t is None:
            continue
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"rglru_scan: {name} must be contiguous float32")
        if tuple(t.shape) != (B, R):
            raise ValueError(f"rglru_scan: {name} {tuple(t.shape)} is not "
                             f"(B,R) = {(B, R)}")
    if B > 65535:
        raise ValueError("rglru_scan: batch must be at most 65535")


def rglru_scan(a, b, h0, h_out=None):
    """a, b (B,S,R) of one dtype; h0 (B,R) float32 -> (hs (B,S,R) in a's
    dtype, h_last (B,R) float32). ``h_last`` is ``h_out`` when given."""
    if a.device.type == "cpu":
        hs, h_last = rglru_scan_ref(a, b, h0)
        if h_out is None:
            return hs, h_last
        return hs, h_out.copy_(h_last)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on CUDA or the CPU, not "
                         f"{a.device}")
    _check(a, b, h0, h_out)
    hs = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    h_last = (torch.empty(h0.shape, dtype=torch.float32, device=a.device)
              if h_out is None else h_out)
    kernel.launch(a, b, h0, hs, h_last)
    rglru_scan.launches += 1
    return hs, h_last


rglru_scan.launches = 0
