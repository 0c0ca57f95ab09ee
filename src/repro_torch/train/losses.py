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
cotangents in bf16 (the same for float32 weights). The vocab-sharded
``shard_map`` branch waits for the mesh tooling.
"""
from __future__ import annotations

import torch

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


def vocab_parallel_ce(hidden, unembed_w, labels, cfg, ctx=None,
                      n_chunks: int = 8, z_loss: float = 0.0):
    """Mean next-token NLL (+ optional z-loss). hidden: (B,S,D);
    unembed_w: (D, Vp); labels: (B,S) int < vocab_size. ``ctx`` must be
    None: the vocab-sharded path needs the mesh tooling."""
    if ctx is not None:
        raise NotImplementedError("vocab_parallel_ce: the vocab-sharded "
                                  "path needs the mesh tooling, which the "
                                  "port does not have yet; pass ctx=None")
    nll, zsq = _chunked_ce_dense(hidden.float(), unembed_w, labels,
                                 n_chunks, cfg.vocab_size)
    return nll + z_loss * zsq
