"""Plain PyTorch version of the RWKV6 wkv recurrence. Counterpart of
``repro/kernels/rwkv6_scan/ref.py::rwkv6_scan_ref`` (and of
``repro/models/rwkv6.py::_wkv_scan``, the same arithmetic).

It is what ``ops.rwkv6_scan`` returns for tensors on the CPU, and what
the CUDA kernel is held against on the card. An exact loop over t in
float32 with a per-(b, h) ``(hd, hd)`` state S:
``o_t = r_t . (S + diag(u) k_t v_t^T)``, then
``S <- diag(exp(logw_t)) S + k_t v_t^T``. ``o`` comes back in ``r``'s
dtype and the final state in float32.

``rwkv6_scan_tiled_ref`` is a plain emulation of the kernel's order of
operations (``rwkv6_scan.cu``): rows in 8 groups, each summed as four
interleaved chains, each group's partial r . S per step kept for a
chunk of steps, then summed in group order and the bonus (r . (u k)) v
added last.
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


def rwkv6_scan_tiled_ref(r, k, v, logw, u, s0, chain=None, chunk=None):
    """As ``rwkv6_scan_ref``, summed as the kernel sums: 8 groups of
    4 ``chain`` rows, each group's r . S as four chains (row 4q + e of
    the group feeds chain e, in q order), added (c0 + c1) + (c2 + c3);
    each chunk of ``chunk`` steps keeps the groups' sums until its walk
    ends, then adds them in group order and the bonus (r . (u k)) v
    last. Defaults to the kernel's plan (``ops.scan_plan``) for these
    shapes."""
    B, S, H, hd = r.shape
    if chain is None or chunk is None:
        from repro_torch.kernels.rwkv6_scan.ops import scan_plan
        plan = scan_plan(B, H, hd, S, r.dtype)
        chain, chunk = plan.chain, plan.chunk
    groups, rows = 8, 32 * chain
    pad = rows - hd

    def padded(t):                                     # rows past hd: 0
        return torch.nn.functional.pad(t.float(), (0, pad))

    rf, kf, wf = padded(r), padded(k), padded(logw)
    vf = v.float()
    uf = padded(u)                                     # (H, rows)
    s = torch.nn.functional.pad(s0.float(), (0, 0, 0, pad))  # (B,H,rows,hd)
    o = torch.empty(B, S, H, hd, dtype=torch.float32, device=r.device)
    for t0 in range(0, S, chunk):
        n = min(chunk, S - t0)
        ruk = (rf[:, t0:t0 + n] * uf * kf[:, t0:t0 + n]).sum(-1)  # (B,n,H)
        sums = []
        for t in range(t0, t0 + n):
            prod = (rf[:, t, :, :, None] * s).view(B, H, groups, chain, 4,
                                                   hd)
            c = prod[:, :, :, 0]                       # the four chains
            for q in range(1, chain):
                c = c + prod[:, :, :, q]
            sums.append((c[:, :, :, 0] + c[:, :, :, 1])
                        + (c[:, :, :, 2] + c[:, :, :, 3]))  # (B,H,8,hd)
            s = (torch.exp(wf[:, t])[..., None] * s
                 + kf[:, t, :, :, None] * vf[:, t, :, None, :])
        for i, g_sums in enumerate(sums):
            acc = g_sums[:, :, 0]
            for g in range(1, groups):                 # group order
                acc = acc + g_sums[:, :, g]
            o[:, t0 + i] = acc + ruk[:, i, :, None] * vf[:, t0 + i]
    return o.to(r.dtype), s[:, :, :hd]
