"""Plain PyTorch version of the RG-LRU scan: the diagonal affine
recurrence ``h_t = a_t * h_{t-1} + b_t`` per channel from ``h0``.
Counterpart of ``repro/kernels/rglru_scan/ref.py::rglru_scan_ref``.

It is what ``ops.rglru_scan`` returns for tensors on the CPU, and what
the CUDA kernel is held against on the card. A loop over t in float32,
the kernel's arithmetic (the reference's oracle is an associative scan:
the same products, associated in another order). ``hs`` comes back in
``a``'s dtype and ``h_last`` in float32.
"""
from __future__ import annotations

import torch


def rglru_scan_ref(a, b, h0):
    """a, b (B,S,R) of one dtype; h0 (B,R) float32 -> (hs (B,S,R) in a's
    dtype, h_last (B,R) float32)."""
    af, bf = a.float(), b.float()
    h = h0.float()
    hs = torch.empty(af.shape, dtype=torch.float32, device=a.device)
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        hs[:, t] = h
    return hs.to(a.dtype), h
