"""Plain PyTorch version of the RWKV6 wkv recurrence. Counterpart of
``repro/kernels/rwkv6_scan/ref.py::rwkv6_scan_ref`` (and of
``repro/models/rwkv6.py::_wkv_scan``, the same arithmetic).

It is what ``ops.rwkv6_scan`` returns for tensors on the CPU, and what
the CUDA kernel is held against on the card. An exact loop over t in
float32 with a per-(b, h) ``(hd, hd)`` state S:
``o_t = r_t . (S + diag(u) k_t v_t^T)``, then
``S <- diag(exp(logw_t)) S + k_t v_t^T``. ``o`` comes back in ``r``'s
dtype and the final state in float32.
"""
from __future__ import annotations

import torch


def rwkv6_scan_ref(r, k, v, logw, u, s0):
    """r, k, v, logw (B,S,H,hd) of one dtype; u (H,hd); s0 (B,H,hd,hd)
    -> (o (B,S,H,hd) in r's dtype, s_last (B,H,hd,hd) float32)."""
    rf, kf, vf, wf = (t.float() for t in (r, k, v, logw))
    uf = u.float()[None, :, :, None]
    s = s0.float().clone()
    o = torch.empty(rf.shape, dtype=torch.float32, device=r.device)
    for t in range(r.shape[1]):
        rt, kt, vt = rf[:, t], kf[:, t], vf[:, t]              # (B,H,hd)
        kv = kt[..., :, None] * vt[..., None, :]               # (B,H,hd,hd)
        o[:, t] = torch.einsum("bhk,bhkv->bhv", rt, s + uf * kv)
        s = torch.exp(wf[:, t])[..., None] * s + kv
    return o.to(r.dtype), s
