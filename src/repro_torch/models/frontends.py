"""Modality frontend stubs: audio/vision archs take precomputed
frame/patch embeddings ``(B, S, D)`` as inputs (``embeds=``).
``fake_embeds`` draws deterministic stand-ins for them.
Counterpart of ``repro/models/frontends.py``."""
from __future__ import annotations

import torch


def uses_embeds(cfg) -> bool:
    return cfg.frontend is not None


def fake_embeds(generator: torch.Generator, cfg, batch: int, seq: int,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """(batch, seq, d_model) embeddings, N(0, 1) x 0.02, drawn in float32
    from ``generator`` on its device, cast to ``dtype`` and moved to
    ``device`` (default: the generator's). The same generator state gives
    the same tensor; JAX's draws are not reproduced, only their shape,
    dtype and scale."""
    z = torch.randn((batch, seq, cfg.d_model), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return z.mul_(0.02).to(device=device or generator.device, dtype=dtype)
