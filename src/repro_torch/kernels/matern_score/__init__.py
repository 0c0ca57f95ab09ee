"""Batched masked Matérn-5/2 candidate scoring and candidate-block
posterior (CUDA kernels + plain PyTorch versions)."""
from repro_torch.kernels.matern_score.ops import (  # noqa: F401
    matern_posterior, matern_score)
from repro_torch.kernels.matern_score.ref import (  # noqa: F401
    matern_posterior_ref, matern_score_ref)
