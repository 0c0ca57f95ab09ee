"""Public wrapper of the ``rwkv6_scan`` kernel. Counterpart of
``repro/kernels/rwkv6_scan/ops.py``.

For tensors on the CPU it returns the plain PyTorch version
(``ref.py``). For CUDA tensors it launches the hand-written kernel
(``kernel.py``) or raises: there is no fallback. Unlike the TPU wrapper
it pads nothing; the kernel walks any S and any head dim up to 256.
``s_out``, when given, receives the final state (it may be ``s0``
itself, so a recurrent state is updated in place: each block of the
kernel reads its tile of the state before it writes it).
``rwkv6_scan.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rwkv6_scan import kernel
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

DTYPES = (torch.float32, torch.bfloat16)


def _check(r, k, v, logw, u, s0, s_out):
    for name, t in dict(k=k, v=v, logw=logw, u=u, s0=s0,
                        s_out=s_out).items():
        if t is not None and t.device != r.device:
            raise ValueError(f"rwkv6_scan: {name} is on {t.device}, r on "
                             f"{r.device}")
    for name, t in dict(r=r, k=k, v=v, logw=logw).items():
        if t.dtype != r.dtype or t.dtype not in DTYPES:
            raise TypeError("rwkv6_scan: r, k, v and logw must share one "
                            "dtype, float32 or bfloat16; got "
                            f"{r.dtype}, {k.dtype}, {v.dtype}, {logw.dtype}")
        if t.ndim != 4 or t.shape != r.shape or t.stride(-1) != 1:
            raise ValueError(f"rwkv6_scan: {name} {tuple(t.shape)} must be "
                             f"r's (B,S,H,hd) {tuple(r.shape)} with a "
                             "contiguous head dim")
    B, _, H, hd = r.shape
    want = dict(u=(H, hd), s0=(B, H, hd, hd), s_out=(B, H, hd, hd))
    for name, t in dict(u=u, s0=s0, s_out=s_out).items():
        if t is None:
            continue
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"rwkv6_scan: {name} must be contiguous float32")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"rwkv6_scan: {name} {tuple(t.shape)} is not "
                             f"{want[name]}")
    if not 0 < hd <= kernel.MAX_HEAD_DIM:
        raise ValueError(f"rwkv6_scan: head dim {hd} is not in 1.."
                         f"{kernel.MAX_HEAD_DIM}")
    if B > 65535 or H > 65535:
        raise ValueError("rwkv6_scan: batch and heads must each be at most "
                         "65535")


def rwkv6_scan(r, k, v, logw, u, s0, s_out=None):
    """r, k, v, logw (B,S,H,hd) of one dtype; u (H,hd) float32; s0
    (B,H,hd,hd) float32 -> (o (B,S,H,hd) in r's dtype, s_last
    (B,H,hd,hd) float32). ``s_last`` is ``s_out`` when given."""
    if r.device.type == "cpu":
        o, s_last = rwkv6_scan_ref(r, k, v, logw, u, s0)
        if s_out is None:
            return o, s_last
        return o, s_out.copy_(s_last)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan runs on CUDA or the CPU, not "
                         f"{r.device}")
    _check(r, k, v, logw, u, s0, s_out)
    o = torch.empty(r.shape, dtype=r.dtype, device=r.device)
    s_last = (torch.empty(s0.shape, dtype=torch.float32, device=r.device)
              if s_out is None else s_out)
    kernel.launch(r, k, v, logw, u, s0, o, s_last)
    rwkv6_scan.launches += 1
    return o, s_last


rwkv6_scan.launches = 0
