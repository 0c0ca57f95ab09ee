"""Split-point execution: partition a decoder stack at layer ``l``, run
the prefix as the *device* half and the suffix as the *server* half, and
move the boundary activation (the paper's D(l)) between them.
Counterpart of ``repro/runtime/splitpoint.py``.

The device-to-server link is a host round trip (``x.cpu()``, then back to
the card), as ``jax.device_get`` is in the reference; the bytes that
cross it are the measured payload the cost model prices. The BO calls
``SplitRunner.run(l, p)`` as its executor, so every evaluation runs an
actual partitioned forward.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models import transformer as tfm


def layer_param(model, idx: int):
    """(kind, block module) for global layer index idx (0-based)."""
    if not 0 <= idx < len(model.layers):
        raise IndexError(idx)
    return model.layers[idx].kind, model.layers[idx]


def run_layers(model, x, positions, lo: int, hi: int):
    """Apply layers [lo, hi) in mode ``train``, without a cache. Returns
    (x, the sum of the layers' MoE aux losses)."""
    for i in range(lo, hi):
        layer_param(model, i)             # IndexError outside [0, L)
    return tfm.apply_layers(model, x, positions, lo, hi)


def device_half(model, tokens=None, embeds=None, positions=None,
                l: int = 0):
    """Embedding + layers [0, l). Returns the boundary activation."""
    dt = tfm.torch_dtype(model.cfg.dtype)
    if embeds is not None:
        x = embeds.to(dt)
    else:
        x = tfm.embed_lookup(model, tokens).to(dt)
    x, _ = run_layers(model, x, positions, 0, l)
    return x


def server_half(model, x, positions, l: int):
    """Layers [l, L) + final norm + unembed -> logits."""
    x, _ = run_layers(model, x, positions, l, model.cfg.n_layers)
    return tfm.logits_fn(model, model.final_norm(x))


class SplitRunner:
    """The two halves of one model + the measured boundary payload."""

    def __init__(self, cfg, model, batch: int, seq: int):
        self.cfg = cfg
        self.model = model
        self.batch = batch
        self.seq = seq

    def run(self, l: int, p_tx_w: float = 0.0,
            tokens: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, int]:
        """Actual partitioned inference. Returns (logits, boundary_bytes).
        p_tx_w only affects the (simulated) link, not the computation."""
        dev = self.model.device
        if tokens is None:
            tokens = torch.zeros(self.batch, self.seq, dtype=torch.int32,
                                 device=dev)
        positions = torch.arange(self.seq, dtype=torch.int32, device=dev
                                 ).expand(self.batch, self.seq)
        l = int(l)
        with torch.inference_mode():
            x = device_half(self.model, tokens=tokens, positions=positions,
                            l=l)
            # device -> server transfer: host round trip = the wireless link
            payload = x.cpu()
            boundary_bytes = payload.numel() * payload.element_size()
            logits = server_half(self.model, payload.to(dev), positions, l)
        return logits, boundary_bytes
