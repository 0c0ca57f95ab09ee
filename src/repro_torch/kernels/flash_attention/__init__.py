"""Causal GQA flash attention: the forward and its backward (CUDA kernels
+ plain PyTorch versions)."""
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    flash_attention, flash_attention_bwd, flash_attention_fwd)
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    attention_bwd_ref, attention_ref)
