"""RG-LRU diagonal affine scan (CUDA kernel + plain PyTorch version)."""
from repro_torch.kernels.rglru_scan.ops import rglru_scan  # noqa: F401
from repro_torch.kernels.rglru_scan.ref import (  # noqa: F401
    rglru_scan_chunked_ref, rglru_scan_ref)
