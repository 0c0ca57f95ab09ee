"""Batched masked Matérn-5/2 candidate scoring (CUDA kernel + plain
PyTorch version)."""
from repro_torch.kernels.matern_score.ops import matern_score  # noqa: F401
from repro_torch.kernels.matern_score.ref import matern_score_ref  # noqa: F401
