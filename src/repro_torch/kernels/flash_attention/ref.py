"""Plain PyTorch version of the flash-attention kernels: dense causal GQA
softmax attention, with an optional sliding window. Counterpart of
``repro/kernels/flash_attention/ref.py::attention_ref``.

``attention_ref`` is what ``ops.flash_attention`` returns for tensors on
the CPU, and what the CUDA kernel is held against on the card. Computed
in float32, masked with -1e30 (not -inf), scale ``1/sqrt(hd)``; the q
row at index i has position i. Output in q's dtype.
``attention_lse_ref`` is the forward's second output, each row's
log-sum-exp in base 2, and ``attention_bwd_ref`` the backward: autograd
through ``attention_ref``. ``attention_tiled_ref`` and
``attention_bwd_tiled_ref`` repeat the kernels' own arithmetic step by
step, for the tests and the card check only; with ``products="3xtf32"``
they form each product as the float32 kernels do on the tensor cores,
from the TF32 parts of ``split_tf32``.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _mask(Sq, Skv, causal, window, device, q0=0, k0=0):
    """Allowed (q, k) pairs of rows q0.. and keys k0.. as bool (Sq, Skv)."""
    qpos = torch.arange(q0, q0 + Sq, device=device)[:, None]
    kpos = torch.arange(k0, k0 + Skv, device=device)[None, :]
    mask = (kpos <= qpos if causal
            else torch.ones(Sq, Skv, dtype=torch.bool, device=device))
    if window:
        mask = mask & (qpos - kpos < window)
    return mask


def _scores(q, k, causal, window):
    """Masked scores (B,Hkv,G,Sq,Skv) in float32, scale 1/sqrt(hd)."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qf = q.reshape(B, Sq, Hkv, Hq // Hkv, hd).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    s = s / math.sqrt(hd)
    return s.masked_fill(~_mask(Sq, Skv, causal, window, q.device), NEG_INF)


def attention_ref(q, k, v, causal: bool = True, window: int = 0):
    """q (B,Sq,Hq,hd); k, v (B,Skv,Hkv,hd) -> (B,Sq,Hq,hd)."""
    B, Sq, Hq, hd = q.shape
    p = torch.softmax(_scores(q, k, causal, window), dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, Hq, hd).to(q.dtype)


LOG2E = 1.4426950408889634
PRODUCTS = ("float32", "3xtf32", "tf32")


def tf32_round(x):
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` does: to 10
    mantissa bits, to nearest with ties away from zero, on the bits (so
    subnormals round at the same place, and a value within half a TF32
    step of the largest float32 rounds to inf); inf and nan are kept.
    The result is float32, its low 13 mantissa bits zero."""
    bits = x.contiguous().view(torch.int32)
    mag = bits & 0x7FFFFFFF
    sign = bits & -0x80000000
    rounded = (((mag + 0x1000) & -0x2000) | sign).view(torch.float32)
    return torch.where(mag >= 0x7F800000, x, rounded)


def split_tf32(x):
    """(hi, lo), both TF32: hi = tf32(x), lo = tf32(x - hi). hi + lo is x
    within 2^-22 of |x| (the float32 kernels' operands, 3xTF32)."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def _product(eq, a, b, products="float32"):
    """``einsum(eq, a, b)`` in float32, its products formed as the
    kernels form them: "float32" as they are; "3xtf32" as the float32
    kernels do on the tensor cores, from the TF32 parts of each operand,
    lo hi + hi lo (the two small terms first) + hi hi, lo lo dropped;
    "tf32" hi hi alone (one TF32 product, no split). The order of the
    float32 sums within a term is the library's, not the tensor
    cores'."""
    if products == "float32":
        return torch.einsum(eq, a, b)
    if products not in PRODUCTS:
        raise ValueError(f"products must be one of {PRODUCTS}")
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    if products == "tf32":
        return torch.einsum(eq, ah, bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def fwd_tiles(hd: int, dtype) -> tuple:
    """The forward kernel's (q rows, keys) a tile: ``Cfg`` of
    flash_attention.cu, the same for bfloat16 (``tc::``) and float32
    (``f32::``, whose warps split each key tile in two up to hd 128)."""
    return 64, (32 if hd > 128 else 64)


def attention_tiled_ref(q, k, v, causal: bool = True, window: int = 0,
                        p_dtype=torch.bfloat16, products: str = "float32"):
    """The forward kernel's arithmetic, step by step, in plain PyTorch:
    64-row q tiles; key tiles of ``fwd_tiles`` from the first that some
    row of the q tile may attend to, tiles wholly masked never seen;
    scores scaled in float32 with log2(e) folded in, masked with -1e30;
    an online softmax in exp2; and P rounded to ``p_dtype`` before P V.
    The default is the bfloat16 kernel (P rounded to bf16, the one
    rounding the plain version does not have; bf16 products are exact in
    float32); ``p_dtype=torch.float32, products="3xtf32"`` is the float32
    kernel (``_product``). Used by the tests and the card check, never by
    the model. Output in q's dtype."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    bq, bk = fwd_tiles(hd, q.dtype)
    scale = torch.tensor(LOG2E / math.sqrt(hd), dtype=torch.float32)
    qf = q.reshape(B, Sq, Hkv, G, hd).float()
    kf, vf = k.float(), v.float()
    out = torch.zeros(B, Sq, Hkv, G, hd, device=q.device)
    for q0 in range(0, Sq, bq):
        q1 = min(q0 + bq, Sq)
        kv_end = min(Skv, q1) if causal else Skv
        kv_begin = max(0, q0 - window + 1) if window else 0
        rows = torch.arange(q0, q1, device=q.device)[:, None]
        m = torch.full((B, Hkv, G, q1 - q0), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, Hkv, G, q1 - q0, hd, device=q.device)
        for k0 in range(kv_begin // bk * bk, kv_end, bk):
            k1 = min(k0 + bk, Skv)
            s = _product("bqhgd,bkhd->bhgqk", qf[:, q0:q1], kf[:, k0:k1],
                         products) * scale
            cols = torch.arange(k0, k1, device=q.device)[None, :]
            mask = (cols <= rows if causal
                    else torch.ones_like(cols <= rows))
            if window:
                mask = mask & (rows - cols < window)
            s = s.masked_fill(~mask, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + _product(
                "bhgqk,bkhd->bhgqd", p.to(p_dtype).float(), vf[:, k0:k1],
                products)
            m = m_new
        den = torch.where(l == 0, torch.ones_like(l), l)
        out[:, q0:q1] = (acc / den[..., None]).permute(0, 3, 1, 2, 4)
    return out.reshape(B, Sq, Hq, hd).to(q.dtype)


def attention_lse_ref(q, k, causal: bool = True, window: int = 0):
    """Each row's log-sum-exp of the masked scores, in base 2 (the
    scores times log2(e) / sqrt(hd)): float32 (B,Hq,Sq), the layout of
    the forward kernel's second output."""
    B, Sq, Hq, _ = q.shape
    lse = torch.logsumexp(_scores(q, k, causal, window), dim=-1) * LOG2E
    return lse.reshape(B, Hq, Sq)


def attention_bwd_ref(q, k, v, dout, causal: bool = True, window: int = 0):
    """The plain backward: autograd through ``attention_ref``. Returns
    (dq, dk, dv) in the inputs' dtypes."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = attention_ref(*leaves, causal=causal, window=window)
        return torch.autograd.grad(out, leaves, dout)


def bwd_tiles(hd: int, dtype) -> dict:
    """The backward kernels' tiles: ``dkv`` (keys a block, q rows a step)
    and ``dq`` (q rows a block, keys a step), 64 keys or rows a block.
    bfloat16 (``tc::Cfg`` of flash_attention_bwd.cu): q steps of 32 and
    key steps of 64 up to hd 64, both 32 up to hd 128 and 16 above;
    float32 (``f32::Cfg``): both 32 up to hd 128 (each split between two
    warps) and 16 above."""
    if dtype == torch.bfloat16:
        step = 64 if hd <= 64 else 32 if hd <= 128 else 16
        return dict(dkv=(64, min(step, 32)), dq=(64, step))
    step = 32 if hd <= 128 else 16
    return dict(dkv=(64, step), dq=(64, step))


def _visits(n_out, b_out, b_in, lo, hi):
    """Per output tile of ``b_out`` rows: the first input tile of ``b_in``
    it visits and how many, from [lo(r0, r1), hi(r0, r1)) of its rows
    [r0, r1)."""
    first, count = [], []
    for t in range(n_out):
        r0, r1 = t * b_out, min((t + 1) * b_out, n_out * b_out)
        a, b = lo(r0, r1), hi(r0, r1)
        first.append(a // b_in)
        count.append(max(0, -(-b // b_in) - a // b_in))
    return first, count


def attention_bwd_tiled_ref(q, k, v, out, lse, dout, causal: bool = True,
                            window: int = 0, p_dtype=torch.float32,
                            products: str = "float32"):
    """The backward kernels' arithmetic, step by step, in plain PyTorch:
    D = rowsum(dO * O) from the forward's rounded output; P recomputed
    from the forward's base-2 ``lse`` as exp2(q.k log2(e)/sqrt(hd) -
    lse), 0 where masked; dq over the key tiles of ``bwd_tiles`` from the
    first that some row of the q tile may attend to; dk and dv per q
    head over q tiles from the first that attends to the key tile, in
    float32, then summed over the group's heads in order. P (before dv)
    and dS (before dq and dk) are rounded to ``p_dtype``: bfloat16 is the
    bf16 kernels' arithmetic; float32 (no rounding) with
    ``products="3xtf32"`` the float32 kernels', each product formed from
    the operands' TF32 parts (``_product``). Every output tile takes its
    steps in the kernels' order; the tiles of one step run side by side
    (a tile past its last step adds exact zeros). Used by the tests and
    the card check, never by the model. Returns (dq, dk, dv) in the
    inputs' dtypes."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dev = q.device
    tiles = bwd_tiles(hd, q.dtype)
    (bq, bk), (bkv, bqs) = tiles["dq"], tiles["dkv"]
    scale = 1.0 / math.sqrt(hd)
    scale_log2 = torch.tensor(LOG2E * scale, dtype=torch.float32)
    # rows and keys padded to whole tiles: zeros, masked
    mq, mk = max(bq, bqs), max(bk, bkv)
    Rq, Rk = -(-Sq // mq) * mq, -(-Skv // mk) * mk

    def pad(x, n):
        return torch.nn.functional.pad(x, (0, 0) * (x.ndim - 2)
                                       + (0, n - x.shape[1]))

    qf = pad(q.float(), Rq).reshape(B, Rq, Hkv, G, hd)
    dof = pad(dout.float(), Rq).reshape(B, Rq, Hkv, G, hd)
    kf, vf = pad(k.float(), Rk), pad(v.float(), Rk)
    L = torch.nn.functional.pad(lse.reshape(B, Hkv, G, Sq), (0, Rq - Sq))
    D = torch.einsum("bqhgd,bqhgd->bhgq", dof,
                     pad(out.float(), Rq).reshape(B, Rq, Hkv, G, hd))
    allowed = torch.zeros(Rq, Rk, dtype=torch.bool, device=dev)
    allowed[:Sq, :Skv] = _mask(Sq, Skv, causal, window, dev)

    def rounded(x):
        return x.to(p_dtype).float()

    def take(x, idx):
        """x (B, R, ...) at rows idx (T, n) -> (B, T, n, ...)"""
        return x[:, idx.reshape(-1)].reshape(x.shape[0], *idx.shape,
                                             *x.shape[2:])

    def step_of(first, count, s, n_in, b_in):
        """Input rows (T, b_in) of step s, and which tiles are live."""
        live = torch.tensor([s < c for c in count], device=dev)
        t = torch.tensor([min(f + s, n_in - 1) for f in first], device=dev)
        return t[:, None] * b_in + torch.arange(b_in, device=dev), live

    # dq: q tiles of bq rows, key tiles of bk
    nq = Rq // bq
    first, count = _visits(
        nq, bq, bk,
        lambda r0, r1: max(0, r0 - window + 1) if window else 0,
        lambda r0, r1: min(Skv, min(r1, Sq)) if causal else Skv)
    qt = qf.reshape(B, nq, bq, Hkv, G, hd)
    dot = dof.reshape(B, nq, bq, Hkv, G, hd)
    Lt, Dt = L.reshape(B, Hkv, G, nq, bq), D.reshape(B, Hkv, G, nq, bq)
    rows = torch.arange(Rq, device=dev).reshape(nq, bq)
    dq = torch.zeros(B, Hkv, G, nq, bq, hd, device=dev)
    for s in range(max(count, default=0)):
        keys, live = step_of(first, count, s, Rk // bk, bk)
        kg, vg = take(kf, keys), take(vf, keys)     # (B, nq, bk, Hkv, hd)
        ok = allowed[rows[:, :, None], keys[:, None, :]] & live[:, None, None]
        sc = _product("btqhgd,btkhd->bhgtqk", qt, kg, products)
        p = torch.exp2(sc * scale_log2 - Lt[..., None]).masked_fill(~ok, 0.0)
        dp = _product("btqhgd,btkhd->bhgtqk", dot, vg, products)
        ds = p * (dp - Dt[..., None])
        dq += _product("bhgtqk,btkhd->bhgtqd", rounded(ds), kg, products)

    # dk, dv per q head: key tiles of bkv, q tiles of bqs
    nk = Rk // bkv
    first, count = _visits(
        nk, bkv, bqs,
        lambda r0, r1: r0 if causal else 0,
        lambda r0, r1: (min(Sq, min(r1, Skv) - 1 + window) if window
                        else Sq))
    kt = kf.reshape(B, nk, bkv, Hkv, hd)
    vt = vf.reshape(B, nk, bkv, Hkv, hd)
    cols = torch.arange(Rk, device=dev).reshape(nk, bkv)
    dkp = torch.zeros(B, Hkv, G, nk, bkv, hd, device=dev)
    dvp = torch.zeros_like(dkp)
    for s in range(max(count, default=0)):
        qrows, live = step_of(first, count, s, Rq // bqs, bqs)
        qg, dg = take(qf, qrows), take(dof, qrows)  # (B, nk, bqs, Hkv, G, hd)
        lg, dsg = L[..., qrows], D[..., qrows]      # (B, Hkv, G, nk, bqs)
        ok = allowed[qrows[:, :, None], cols[:, None, :]] & live[:, None, None]
        sc = _product("btqhgd,btkhd->bhgtqk", qg, kt, products)
        p = torch.exp2(sc * scale_log2 - lg[..., None]).masked_fill(~ok, 0.0)
        dp = _product("btqhgd,btkhd->bhgtqk", dg, vt, products)
        ds = p * (dp - dsg[..., None])
        dvp += _product("bhgtqk,btqhgd->bhgtkd", rounded(p), dg, products)
        dkp += _product("bhgtqk,btqhgd->bhgtkd", rounded(ds), qg, products)

    dkp = dkp.reshape(B, Hkv, G, Rk, hd)[:, :, :, :Skv]
    dvp = dvp.reshape(B, Hkv, G, Rk, hd)[:, :, :, :Skv]
    dk, dv = dkp[:, :, 0] * scale, dvp[:, :, 0]
    for g in range(1, G):
        dk = dk + dkp[:, :, g] * scale
        dv = dv + dvp[:, :, g]
    dq = (dq.reshape(B, Hkv, G, Rq, hd)[:, :, :, :Sq] * scale)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, hd)
    return (dq.to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))
