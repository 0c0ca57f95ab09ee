"""One-token decode attention against a ring-buffer KV cache (CUDA
kernel + plain PyTorch version)."""
from repro_torch.kernels.decode_attention.ops import decode_attention  # noqa: F401
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: F401
