"""Sequence-chunked cross-entropy. Counterpart of the single-shard path of
``repro/train/losses.py`` (``_chunked_ce_dense``, and
``vocab_parallel_ce`` with no mesh).

The (B,S,V) logits are never held: the flattened tokens are cut into
``n_chunks`` chunks, and each chunk's (T/n, Vp) float32 logits exist only
while that chunk is summed, in the forward and in the backward, which
recomputes them (``ChunkedCE``, a ``torch.autograd.Function``; plain
autograd over the loop would keep every chunk's logits, 1.2 GB at
Qwen2-1.5B's vocab and 2048 tokens). As in the reference the hidden
state is cast to float32, so the vocab product runs in float32, with
TF32 off in the forward and the backward alike. It is a plain matrix
product outside any Pallas kernel, so it stays ``torch.matmul``. The
padded vocab tail is masked to -1e30 and gets no gradient.

The unembedding's gradient is summed over the chunks in float32 and cast
to its dtype once, where the reference's scan sums the chunks' bf16
cotangents in bf16 (the same for float32 weights).

Under a ``ShardCtx`` whose rules put ``vocab`` on a ``model`` axis of
more than one rank, ``VocabParallelCE`` runs the reference's
``shard_map`` body: each rank holds the vocab columns [lo, lo + vloc)
and the tokens of its batch shard (replicated over ``model``), masks the
padded tail by the global column index, and combines the chunk's
log-sum-exp over ``model`` by one max and one sum (the label's logit
summed with the denominator). In the backward dW stays the rank's own
and dh is summed over ``model``; the max shift carries no gradient.
Under any mesh the loss is then averaged over the batch axes
(``collectives.all_mean``, the reference's ``pmean``).
"""
from __future__ import annotations

import torch

from repro_torch.distributed.collectives import all_mean, mesh_collective
from repro_torch.models.moe import no_tf32

NEG_INF = -1e30


def _chunks(T: int, n_chunks: int):
    """The reference's ceil(T / n)-token chunks, cut at T."""
    cs = -(-T // n_chunks)
    return [(c * cs, min((c + 1) * cs, T)) for c in range(n_chunks)]


def _chunk_logits(hc, w32, vocab_valid):
    """(cs, Vp) float32 logits with the padded vocab tail at -1e30, and
    their log-sum-exp."""
    logits = hc @ w32
    vmask = torch.arange(logits.shape[-1], device=logits.device) < vocab_valid
    logits = torch.where(vmask, logits, torch.full_like(logits, NEG_INF))
    return logits, torch.logsumexp(logits, dim=-1)


class ChunkedCE(torch.autograd.Function):
    """(sum of NLL, sum of z^2) over the T tokens, each divided by T."""

    @staticmethod
    def forward(ctx, h, w, labels, n_chunks: int, vocab_valid: int):
        T = h.shape[0]
        spans = _chunks(T, n_chunks)
        nll = torch.zeros((), dtype=torch.float32, device=h.device)
        zsq = torch.zeros((), dtype=torch.float32, device=h.device)
        with no_tf32():
            w32 = w.float()
            for lo, hi in spans:
                if lo >= hi:      # a padded chunk adds zeros
                    continue
                logits, lz = _chunk_logits(h[lo:hi], w32, vocab_valid)
                ll = torch.gather(logits, 1, labels[lo:hi, None])[:, 0]
                nll = nll + (lz - ll).sum()
                zsq = zsq + torch.square(lz).sum()
        ctx.save_for_backward(h, w, labels)
        ctx.n_chunks, ctx.vocab_valid = n_chunks, vocab_valid
        return nll / T, zsq / T

    @staticmethod
    def backward(ctx, g_nll, g_zsq):
        h, w, labels = ctx.saved_tensors
        T = h.shape[0]
        spans = _chunks(T, ctx.n_chunks)
        dh = torch.empty_like(h)
        with no_tf32():
            w32 = w.float()
            dw = torch.zeros_like(w32)
            a = g_nll.float() / T                       # d loss / d nll_t
            for lo, hi in reversed(spans):              # as the scan's
                if lo >= hi:                            # transpose
                    continue
                hc = h[lo:hi]
                logits, lz = _chunk_logits(hc, w32, ctx.vocab_valid)
                p = torch.exp(logits - lz[:, None])     # 0 on the tail
                coef = a + g_zsq.float() / T * 2.0 * lz
                dlog = p * coef[:, None]
                rows = torch.arange(hi - lo, device=h.device)
                lab = labels[lo:hi]
                dlog[rows, lab] = dlog[rows, lab] - a
                dh[lo:hi] = dlog @ w32.t()
                dw += hc.t() @ dlog
        return dh, dw.to(w.dtype), None, None, None


def _chunked_ce_dense(hidden, w, labels, n_chunks: int, vocab_valid: int):
    """Single-shard path: chunk over flattened tokens. hidden (B,S,D)
    float32, w (D,Vp), labels (B,S) -> (mean NLL, mean z^2)."""
    B, S, D = hidden.shape
    return ChunkedCE.apply(hidden.reshape(B * S, D), w,
                           labels.reshape(B * S).long(), n_chunks,
                           vocab_valid)


class VocabParallelCE(torch.autograd.Function):
    """(sum of NLL, sum of z^2) over the rank's T tokens, each divided by
    T, with ``w`` the rank's vocab columns from ``lo`` over ``model``."""

    @staticmethod
    def forward(fctx, h, w, labels, n_chunks: int, vocab_valid: int, ctx):
        T, vloc = h.shape[0], w.shape[1]
        lo = ctx.index("model") * vloc
        nll = torch.zeros((), dtype=torch.float32, device=h.device)
        zsq = torch.zeros((), dtype=torch.float32, device=h.device)
        lz_all = torch.empty(T, dtype=torch.float32, device=h.device)
        col = lo + torch.arange(vloc, device=h.device)
        with no_tf32():
            w32 = w.float()
            for a, b in _chunks(T, n_chunks):
                if a >= b:
                    continue
                logits = h[a:b] @ w32
                logits = torch.where(col < vocab_valid, logits,
                                     torch.full_like(logits, NEG_INF))
                m = mesh_collective("max", logits.amax(dim=-1), ctx)
                loc = labels[a:b] - lo
                ok = (loc >= 0) & (loc < vloc)
                ll = torch.where(ok, torch.gather(
                    logits, 1, loc.clamp(0, vloc - 1)[:, None])[:, 0], 0.0)
                both = mesh_collective("sum", torch.stack(
                    [torch.exp(logits - m[:, None]).sum(dim=-1), ll]), ctx)
                lz = m + torch.log(both[0])
                lz_all[a:b] = lz
                nll = nll + (lz - both[1]).sum()
                zsq = zsq + torch.square(lz).sum()
        fctx.save_for_backward(h, w, labels, lz_all)
        fctx.n_chunks, fctx.vocab_valid, fctx.ctx = n_chunks, vocab_valid, ctx
        return nll / T, zsq / T

    @staticmethod
    def backward(fctx, g_nll, g_zsq):
        h, w, labels, lz_all = fctx.saved_tensors
        ctx = fctx.ctx
        T, vloc = h.shape[0], w.shape[1]
        lo = ctx.index("model") * vloc
        col = lo + torch.arange(vloc, device=h.device)
        dh = torch.empty_like(h)
        with no_tf32():
            w32 = w.float()
            dw = torch.zeros_like(w32)
            a_ = g_nll.float() / T
            for a, b in reversed(_chunks(T, fctx.n_chunks)):
                if a >= b:
                    continue
                hc = h[a:b]
                logits = hc @ w32
                logits = torch.where(col < fctx.vocab_valid, logits,
                                     torch.full_like(logits, NEG_INF))
                lz = lz_all[a:b]
                p = torch.exp(logits - lz[:, None])
                coef = a_ + g_zsq.float() / T * 2.0 * lz
                dlog = p * coef[:, None]
                # the label's column, where it is this rank's: a compare
                # against the columns, not a boolean index (whose shape
                # depends on the data, which a fake trace cannot follow)
                dlog = torch.where(labels[a:b, None] == col, dlog - a_,
                                   dlog)
                dh[a:b] = dlog @ w32.t()
                dw += hc.t() @ dlog
        # the tokens are replicated over model: dh is each rank's term
        dh = mesh_collective("sum", dh, ctx)
        return dh, dw.to(w.dtype), None, None, None, None


def _batch_axes(ctx):
    b = None if ctx is None else ctx.rules.get("batch")
    return () if b is None else ((b,) if isinstance(b, str) else tuple(b))


def vocab_parallel_ce(hidden, unembed_w, labels, cfg, ctx=None,
                      n_chunks: int = 8, z_loss: float = 0.0):
    """Mean next-token NLL (+ optional z-loss). hidden: (B,S,D), the
    rank's batch shard under ``ctx``; unembed_w: (D, Vp), or the rank's
    vocab columns where the rules shard ``vocab`` over ``model``;
    labels: (B,S) int < vocab_size. Under ``ctx`` the mean is over the
    global batch, the same on every rank."""
    B, S, D = hidden.shape
    if (ctx is None or ctx.rules.get("vocab") != "model"
            or ctx.size("model") <= 1):
        nll, zsq = _chunked_ce_dense(hidden.float(), unembed_w, labels,
                                     n_chunks, cfg.vocab_size)
    else:
        nll, zsq = VocabParallelCE.apply(
            hidden.float().reshape(B * S, D), unembed_w,
            labels.reshape(B * S).long(), n_chunks, cfg.vocab_size, ctx)
    loss = nll + z_loss * zsq
    return all_mean(loss, ctx, _batch_axes(ctx)) if ctx is not None else loss
