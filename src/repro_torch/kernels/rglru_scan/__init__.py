"""RG-LRU diagonal affine scan (CUDA kernel + plain PyTorch version)."""
from repro_torch.kernels.rglru_scan.ops import (  # noqa: F401
    RGLRUScan, rglru_scan, rglru_scan_bwd)
from repro_torch.kernels.rglru_scan.ref import (  # noqa: F401
    rglru_scan_bwd_chunked_ref, rglru_scan_bwd_ref, rglru_scan_chunked_ref,
    rglru_scan_ref)
