"""Serving steps: prefill (S tokens -> cache + first token) and decode
(one token against the cache), and the greedy generation loop.
Counterpart of ``repro/runtime/serve.py``; the cache is written in
place.

Under a ``ShardCtx`` (``ctx``, the one the model was built with,
``Transformer(cfg, ctx=...)``) each rank runs the steps on its rows of
the batch (``ctx.local(tokens, ("batch", None))``) with its cache
shards (``init_cache(..., ctx=ctx)``), and gets every token's logits
over the whole vocab; ``greedy_generate`` takes the whole prompt, splits
it over ``data`` and gathers the generated tokens back, so every rank
returns the whole batch's. ``ctx=None`` is the single-device path.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.collectives import mesh_collective
from repro_torch.models import frontends
from repro_torch.models import transformer as tfm


def _check_ctx(model, ctx) -> None:
    if ctx is not model.ctx:
        raise ValueError("the step's ctx is not the one the model was "
                         "built with")


def make_prefill_step(cfg, ctx=None):
    def prefill(model, batch, cache):
        _check_ctx(model, ctx)
        if "embeds" in batch:
            inp = dict(embeds=batch["embeds"])
            B, S = batch["embeds"].shape[:2]
        else:
            inp = dict(tokens=batch["tokens"])
            B, S = batch["tokens"].shape
        dev = model.device
        positions = torch.arange(S, dtype=torch.int32, device=dev
                                 ).expand(B, S)
        with torch.inference_mode():
            hidden, cache, _ = tfm.forward(model, positions=positions,
                                           cache=cache, t=0, mode="prefill",
                                           **inp)
            logits = tfm.logits_fn(model, hidden[:, -1:])
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, cache
    return prefill


def make_decode_step(cfg, ctx=None):
    def decode(model, token, cache, t: int):
        """token: (B,1) int32 (or (B,1,D) embeds for stub frontends);
        t: the current position."""
        _check_ctx(model, ctx)
        B = token.shape[0]
        positions = torch.full((B, 1), int(t), dtype=torch.int32,
                               device=model.device)
        if frontends.uses_embeds(cfg):
            inp = dict(embeds=token)
        else:
            inp = dict(tokens=token)
        with torch.inference_mode():
            hidden, cache, _ = tfm.forward(model, positions=positions,
                                           cache=cache, t=int(t),
                                           mode="decode", **inp)
            logits = tfm.logits_fn(model, hidden)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, cache
    return decode


def greedy_generate(model, cfg, prompt_tokens, n_new: int, max_seq: int,
                    ctx=None):
    """Generation loop: prefill + (n_new - 1) greedy decode steps.
    Returns (B, n_new) int32 tokens (under ``ctx``, the whole batch's on
    every rank)."""
    B, S = prompt_tokens.shape
    cache = tfm.init_cache(cfg, B, max_seq, dtype=cfg.dtype,
                           device=model.device, ctx=ctx)
    if ctx is not None:
        prompt_tokens = ctx.local(prompt_tokens, ("batch", None))
    prefill = make_prefill_step(cfg, ctx)
    decode = make_decode_step(cfg, ctx)
    tok, cache = prefill(model, dict(tokens=prompt_tokens), cache)
    out = [tok]
    t = S
    for _ in range(n_new - 1):
        tok, cache = decode(model, tok, cache, t)
        out.append(tok)
        t += 1
    return mesh_collective("gather", torch.cat(out, dim=1), ctx, "data",
                           dim=0)
