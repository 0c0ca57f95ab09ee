"""RWKV6 wkv recurrence (CUDA kernel + plain PyTorch version)."""
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan  # noqa: F401
from repro_torch.kernels.rwkv6_scan.ref import (  # noqa: F401
    rwkv6_scan_ref, rwkv6_scan_tiled_ref)
