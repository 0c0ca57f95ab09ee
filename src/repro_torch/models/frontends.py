"""Modality frontend stubs: audio/vision archs take precomputed
frame/patch embeddings ``(B, S, D)`` as inputs (``embeds=``).
Counterpart of ``repro/models/frontends.py``."""
from __future__ import annotations


def uses_embeds(cfg) -> bool:
    return cfg.frontend is not None
