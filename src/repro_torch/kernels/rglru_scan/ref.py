"""Plain PyTorch version of the RG-LRU scan: the diagonal affine
recurrence ``h_t = a_t * h_{t-1} + b_t`` per channel from ``h0``.
Counterpart of ``repro/kernels/rglru_scan/ref.py::rglru_scan_ref``.

It is what ``ops.rglru_scan`` returns for tensors on the CPU, and what
the CUDA kernel is held against on the card. A loop over t in float32,
the kernel's arithmetic (the reference's oracle is an associative scan:
the same products, associated in another order). ``hs`` comes back in
``a``'s dtype and ``h_last`` in float32.

``rglru_scan_chunked_ref`` is a plain emulation of the CUDA kernel's
order of operations (``rglru_scan.cu``): S in pieces of ``chunks`` chunks
of ``chunk`` steps, each chunk folded into its map h -> A h + Bc, h0
carried through the maps in chunk order, then each chunk walked again
from its carry. Its fused multiply-adds are taken in float64 and rounded
to float32, as ``fmaf`` rounds them.
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


def _fma(x, y, z):
    """``fmaf(x, y, z)`` on float32 tensors: the product is exact in
    float64, and the sum rounds there and then to float32 (one rounding
    but where the float64 sum lands on a float32 tie)."""
    return (x.double() * y.double() + z.double()).float()


def rglru_scan_chunked_ref(a, b, h0, chunks=None, chunk=None):
    """As ``rglru_scan_ref``, in the kernel's order: pieces of ``chunks``
    chunks of ``chunk`` steps (defaults: ``ops.scan_plan``'s; with only
    ``chunks``, one piece of chunks of ceil(S / chunks) steps). Steps
    past S are a = 1, b = 0. Walk 1 folds each chunk into (A, Bc) with
    Bc <- fma(a, Bc, b), A <- a A; the carry runs
    carry_{c+1} = fma(A_c, carry_c, Bc_c) from h0, or from the last h of
    the piece before; walk 2 is h <- fma(a, h, b) from each carry. One
    chunk skips walk 1 and the carry. ``h_last`` is walk 2's h in the
    chunk that holds step S - 1."""
    B, S, R = a.shape
    if chunks is None:
        from repro_torch.kernels.rglru_scan.ops import scan_plan
        plan = scan_plan(B, S, R, a.dtype)
        chunks, chunk = plan.chunks, plan.chunk
    elif chunk is None:
        chunk = max(1, -(-S // chunks))
    piece = chunks * chunk
    af, bf = a.float(), b.float()
    h = h0.float()
    hs = torch.empty(B, S, R, dtype=torch.float32, device=a.device)
    for p0 in range(0, S, piece):
        n = min(piece, S - p0)
        pa = torch.ones(B, piece, R, dtype=torch.float32, device=a.device)
        pb = torch.zeros(B, piece, R, dtype=torch.float32, device=a.device)
        pa[:, :n], pb[:, :n] = af[:, p0:p0 + n], bf[:, p0:p0 + n]
        pa = pa.view(B, chunks, chunk, R)
        pb = pb.view(B, chunks, chunk, R)
        if chunks == 1:
            walk = h[:, None]
        else:
            A = torch.ones(B, chunks, R, dtype=torch.float32,
                           device=a.device)
            Bc = torch.zeros_like(A)
            for i in range(chunk):                        # walk 1
                Bc = _fma(pa[:, :, i], Bc, pb[:, :, i])
                A = pa[:, :, i] * A
            walk = torch.empty_like(A)
            for k in range(chunks):                       # carry
                walk[:, k] = h
                h = _fma(A[:, k], h, Bc[:, k])
        out = torch.empty(B, chunks, chunk, R, dtype=torch.float32,
                          device=a.device)
        for i in range(chunk):                            # walk 2
            walk = _fma(pa[:, :, i], walk, pb[:, :, i])
            out[:, :, i] = walk
        hs[:, p0:p0 + n] = out.view(B, piece, R)[:, :n]
        h = walk[:, ((S - 1) % piece) // chunk if p0 + piece >= S
                 else chunks - 1]
    return hs.to(a.dtype), h


def rglru_scan_bwd_ref(a, h0, hs, dhs, dh_last=None):
    """Cotangents (da, db, dh0) of ``rglru_scan_ref(a, b, h0)`` = (hs,
    h_last) at (dhs, dh_last): a, hs, dhs (B,S,R); h0, dh_last (B,R),
    ``dh_last`` None as zero. da and db come back in a's dtype, dh0 in
    float32. An explicit loop from the last step to the first."""
    af, hf, dh = a.float(), hs.float(), dhs.float()
    B, S, R = af.shape
    g = (torch.zeros(B, R, dtype=torch.float32, device=a.device)
         if dh_last is None else dh_last.float())
    coef = torch.ones(B, R, dtype=torch.float32, device=a.device)  # a_S
    da = torch.empty(B, S, R, dtype=torch.float32, device=a.device)
    db = torch.empty_like(da)
    for t in reversed(range(S)):
        g = dh[:, t] + coef * g
        db[:, t] = g
        da[:, t] = g * (hf[:, t - 1] if t else h0.float())
        coef = af[:, t]
    return da.to(a.dtype), db.to(a.dtype), coef * g


def rglru_scan_bwd_chunked_ref(a, h0, hs, dhs, dh_last=None, chunks=None,
                               chunk=None):
    """As ``rglru_scan_bwd_ref``, in the backward kernel's order: the
    forward's pieces (``rglru_scan_chunked_ref``'s ``chunks`` and
    ``chunk``), taken from the last to the first. A step t's map is
    g <- fma(a_{t+1}, g, dhs_t) (a_S = 1; steps past S are a = 1,
    dhs = 0). Walk 1 folds each chunk from its last step into (A, Bc);
    the carry runs carry_c = fma(A_{c+1}, carry_{c+1}, Bc_{c+1}) from
    the last chunk, entered with dh_last or the g of the piece after;
    walk 2 reruns each chunk from its carry and writes db = g and
    da = g h_{t-1}. One chunk skips walk 1 and the carry. dh0 = a_0 g_0."""
    B, S, R = a.shape
    if chunks is None:
        from repro_torch.kernels.rglru_scan.ops import scan_plan
        plan = scan_plan(B, S, R, a.dtype)
        chunks, chunk = plan.chunks, plan.chunk
    elif chunk is None:
        chunk = max(1, -(-S // chunks))
    piece = chunks * chunk
    dev = a.device
    af, dh = a.float(), dhs.float()
    ones = torch.ones(B, 1, R, dtype=torch.float32, device=dev)
    ash = torch.cat([af[:, 1:], ones], dim=1)             # a_{t+1}
    hprev = torch.cat([h0.float()[:, None], hs.float()[:, :-1]], dim=1)
    g = (torch.zeros(B, R, dtype=torch.float32, device=dev)
         if dh_last is None else dh_last.float())
    da = torch.empty(B, S, R, dtype=torch.float32, device=dev)
    db = torch.empty_like(da)
    for p0 in reversed(range(0, S, piece)):
        n = min(piece, S - p0)
        pa = torch.ones(B, piece, R, dtype=torch.float32, device=dev)
        pd = torch.zeros(B, piece, R, dtype=torch.float32, device=dev)
        pa[:, :n], pd[:, :n] = ash[:, p0:p0 + n], dh[:, p0:p0 + n]
        pa = pa.view(B, chunks, chunk, R)
        pd = pd.view(B, chunks, chunk, R)
        if chunks == 1:
            walk = g[:, None]
        else:
            A = torch.ones(B, chunks, R, dtype=torch.float32, device=dev)
            Bc = torch.zeros_like(A)
            for i in reversed(range(chunk)):              # walk 1
                Bc = _fma(pa[:, :, i], Bc, pd[:, :, i])
                A = pa[:, :, i] * A
            walk = torch.empty_like(A)
            for c in reversed(range(chunks)):             # carry
                walk[:, c] = g
                g = _fma(A[:, c], g, Bc[:, c])
        out = torch.empty(B, chunks, chunk, R, dtype=torch.float32,
                          device=dev)
        for i in reversed(range(chunk)):                  # walk 2
            walk = _fma(pa[:, :, i], walk, pd[:, :, i])
            out[:, :, i] = walk
        out = out.view(B, piece, R)[:, :n]
        db[:, p0:p0 + n] = out
        da[:, p0:p0 + n] = out * hprev[:, p0:p0 + n]
        g = walk[:, 0]
    dh0 = af[:, 0] * g if S else g
    return da.to(a.dtype), db.to(a.dtype), dh0
