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

``rwkv6_scan_bwd_ref`` is the backward, a plain reverse loop over the
states the forward went through; ``rwkv6_checkpoints_ref`` gives the
states every ``CKPT_STEPS`` steps that the forward kernel saves for
the backward kernel; ``rwkv6_scan_bwd_tiled_ref`` emulates the backward
kernels' order of operations.
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


CKPT_STEPS = 8          # steps between the states the forward saves


def _states(kf, vf, wf, s0):
    """The state before each step t: (B, S, H, hd, hd) float32."""
    s = s0.float().clone()
    out = []
    for t in range(kf.shape[1]):
        out.append(s)
        s = (torch.exp(wf[:, t])[..., None] * s
             + kf[:, t, :, :, None] * vf[:, t, :, None, :])
    B, S, H, hd = kf.shape
    if not out:
        return torch.empty(B, 0, H, hd, hd, dtype=torch.float32,
                           device=kf.device)
    return torch.stack(out, dim=1)


def rwkv6_checkpoints_ref(r, k, v, logw, u, s0):
    """The state before steps 0, CKPT_STEPS, 2 CKPT_STEPS, ...: (B,
    ceil(S / CKPT_STEPS), H, hd, hd) float32, as the forward kernel saves
    it when autograd records (its first is s0)."""
    return _states(k.float(), v.float(), logw.float(),
                   s0)[:, ::CKPT_STEPS].contiguous()


def rwkv6_scan_bwd_ref(r, k, v, logw, u, s0, do, ds_last=None):
    """Cotangents (dr, dk, dv, dlogw, du, ds0) of ``rwkv6_scan_ref(r, k,
    v, logw, u, s0)`` = (o, s_last) at (do, ds_last); ``ds_last`` None
    counts as zero. dr, dk, dv, dlogw come back in r's dtype, du (H,hd)
    and ds0 (B,H,hd,hd) in float32. With G the cotangent of the state
    after step t (G = ds_last after the last step) and S_{t-1} the state
    before it, from the last step to the first:
        dr_t    = S_{t-1} do_t + u k_t (v_t . do_t)
        dk_t    = G v_t + u r_t (v_t . do_t)
        dv_t    = G^T k_t + (r_t . (u k_t)) do_t
        dlogw_t = w_t * rowsum(G * S_{t-1})
        G      <- diag(w_t) G + r_t do_t^T
    then du = sum over b and t of r_t k_t (v_t . do_t) and ds0 = G."""
    rf, kf, vf, wf, dof = (t.float() for t in (r, k, v, logw, do))
    uf = u.float()
    B, S, H, hd = rf.shape
    states = _states(kf, vf, wf, s0)
    G = (torch.zeros(B, H, hd, hd, dtype=torch.float32, device=r.device)
         if ds_last is None else ds_last.float().clone())
    dr, dk, dv, dlogw = (torch.empty(B, S, H, hd, dtype=torch.float32,
                                     device=r.device) for _ in range(4))
    du = torch.zeros(H, hd, dtype=torch.float32, device=r.device)
    for t in reversed(range(S)):
        rt, kt, vt, dot = rf[:, t], kf[:, t], vf[:, t], dof[:, t]
        wt = torch.exp(wf[:, t])
        vdo = (vt * dot).sum(-1, keepdim=True)             # (B,H,1)
        sp = states[:, t]
        dr[:, t] = torch.einsum("bhij,bhj->bhi", sp, dot) + uf * kt * vdo
        dk[:, t] = torch.einsum("bhij,bhj->bhi", G, vt) + uf * rt * vdo
        dv[:, t] = (torch.einsum("bhij,bhi->bhj", G, kt)
                    + (rt * uf * kt).sum(-1, keepdim=True) * dot)
        dlogw[:, t] = wt * (G * sp).sum(-1)
        du += (rt * kt * vdo).sum(0)
        G = wt[..., None] * G + rt[..., :, None] * dot[..., None, :]
    dt = r.dtype
    return dr.to(dt), dk.to(dt), dv.to(dt), dlogw.to(dt), du, G


LANES = 16              # lanes of the row kernel that share a row
WIDTHS = (32, 64, 160, 256)   # the row kernel's instances: padded columns


def lane_columns(hd: int) -> int:
    """Columns a lane holds in the backward's row kernel: the smallest
    instance width (32, 64, 160, 256) that covers hd, over the LANES
    lanes (10 at hd 160)."""
    return next(w for w in WIDTHS if w >= hd) // LANES


def _butterfly(p):
    """The xor-butterfly sum over the last dim (a power of two): halves
    added pairwise, (p[i] + p[i + n/2]), until one is left."""
    while p.shape[-1] > 1:
        n = p.shape[-1] // 2
        p = p[..., :n] + p[..., n:]
    return p[..., 0]


def _lane_sum(x, y, C):
    """sum_j x_j y_j over the last dim as the row kernel takes it: lane
    l chains columns l C .. l C + C - 1 in order, the LANES lanes' sums
    by the butterfly. x, y padded to LANES C columns."""
    xs = x.unflatten(-1, (LANES, C))
    ys = y.unflatten(-1, (LANES, C))
    acc = xs[..., 0] * ys[..., 0]
    for m in range(1, C):
        acc = acc + xs[..., m] * ys[..., m]
    return _butterfly(acc)


def rwkv6_scan_bwd_tiled_ref(r, k, v, logw, u, s0, do, ds_last=None):
    """As ``rwkv6_scan_bwd_ref``, summed as the backward kernels sum.
    dv and ds0 are the forward scan in reverse time (read-out k, update
    r do^T, from ds_last), so ``rwkv6_scan_tiled_ref`` gives them on the
    time-reversed inputs. dr, dk and dlogw are the row kernel's: each
    of a row's ``LANES`` lanes' ``lane_columns`` columns chained in
    order, the lanes by the butterfly, the bonus added last; v . do by
    32 strided lane sums and the butterfly; du each row's chain over t
    from the last step, then the batch rows in order."""
    B, S, H, hd = r.shape
    flip = (lambda t: t.flip(1))                           # noqa: E731
    zero = torch.zeros(B, H, hd, hd, dtype=torch.float32, device=r.device)
    o_rev, ds0 = rwkv6_scan_tiled_ref(
        flip(k.float()), flip(r.float()), flip(do.float()),
        flip(logw.float()), u, zero if ds_last is None else ds_last)
    dv = flip(o_rev)
    rf, kf, vf, wf, dof = (t.float() for t in (r, k, v, logw, do))
    uf = u.float()
    C = lane_columns(hd)
    pad = LANES * C - hd

    def cols(t):                                           # columns padded
        return torch.nn.functional.pad(t, (0, pad))

    states = _states(kf, vf, wf, s0)
    G = zero.clone() if ds_last is None else ds_last.float().clone()
    dr, dk, dlogw = (torch.empty(B, S, H, hd, dtype=torch.float32,
                                 device=r.device) for _ in range(3))
    vp = torch.nn.functional.pad(vf, (0, -hd % 32)).unflatten(-1, (-1, 32))
    dp = torch.nn.functional.pad(dof, (0, -hd % 32)).unflatten(-1, (-1, 32))
    vdo_lanes = vp[..., 0, :] * dp[..., 0, :]
    for q in range(1, vp.shape[-2]):
        vdo_lanes = vdo_lanes + vp[..., q, :] * dp[..., q, :]
    vdo_all = _butterfly(vdo_lanes)                        # (B,S,H)
    du_part = torch.zeros(B, H, hd, dtype=torch.float32, device=r.device)
    for t in reversed(range(S)):
        rt, kt, vt, dot = rf[:, t], kf[:, t], vf[:, t], dof[:, t]
        wt = torch.exp(wf[:, t])
        vdo = vdo_all[:, t, :, None]
        sp = cols(states[:, t])
        Gp = cols(G)
        dr[:, t] = _lane_sum(sp, cols(dot)[..., None, :], C) + uf * kt * vdo
        dk[:, t] = _lane_sum(Gp, cols(vt)[..., None, :], C) + uf * rt * vdo
        dlogw[:, t] = wt * _lane_sum(Gp, sp, C)
        du_part = du_part + rt * kt * vdo
        G = wt[..., None] * G + rt[..., :, None] * dot[..., None, :]
    du = du_part[0]
    for b in range(1, B):
        du = du + du_part[b]
    dt = r.dtype
    return dr.to(dt), dk.to(dt), dv.to(dt), dlogw.to(dt), du, ds0
