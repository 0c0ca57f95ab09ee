"""RWKV6 wkv recurrence (CUDA kernel + plain PyTorch version)."""
from repro_torch.kernels.rwkv6_scan.ops import (  # noqa: F401
    RWKV6Scan, rwkv6_scan, rwkv6_scan_bwd, rwkv6_scan_fwd)
from repro_torch.kernels.rwkv6_scan.ref import (  # noqa: F401
    rwkv6_checkpoints_ref, rwkv6_scan_bwd_ref, rwkv6_scan_bwd_tiled_ref,
    rwkv6_scan_ref, rwkv6_scan_tiled_ref)
