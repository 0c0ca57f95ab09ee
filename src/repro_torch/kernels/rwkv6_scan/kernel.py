"""Build and launch the Hopper CUDA ``rwkv6_scan`` kernel.

Counterpart of ``repro/kernels/rwkv6_scan/kernel.py`` (the Pallas TPU
kernel); the design note is at the top of ``rwkv6_scan.cu``. The build
(``nvcc -shared`` at first use, loaded with ``ctypes``) is
``kernels/nvcc.py``'s.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.nvcc import (DTYPE_BFLOAT16, DTYPE_FLOAT32,
                                      CudaLibrary)

MAX_HEAD_DIM = 256        # the largest instance: 8 groups of 32 rows


def _declare(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rwkv6_scan_launch.argtypes = [p] * 8 + [ll] * 12 + [i] * 5 + [p]
    lib.rwkv6_scan_launch.restype = i
    for name in ("rwkv6_scan_smem_bytes", "rwkv6_scan_blocks_per_sm"):
        getattr(lib, name).argtypes = [i, i]
        getattr(lib, name).restype = i


LIB = CudaLibrary(Path(__file__).with_name("rwkv6_scan.cu"), _declare)


def launch(r, k, v, logw, u, s0, o, s_out) -> None:
    """Launch on the current stream of ``o``'s device. The tensors are
    checked by the caller (``ops.rwkv6_scan``)."""
    import torch

    lib = LIB.load()
    B, S, H, hd = r.shape
    strides = [s for t in (r, k, v, logw) for s in t.stride()[:3]]
    dtype = _dtype_code(r.dtype)
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        err = lib.rwkv6_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), s0.data_ptr(), o.data_ptr(), s_out.data_ptr(),
            *strides, B, S, H, hd, dtype, stream)
    LIB.check(err, "rwkv6_scan")


def _dtype_code(dtype) -> int:
    import torch

    return DTYPE_BFLOAT16 if dtype == torch.bfloat16 else DTYPE_FLOAT32


def smem_bytes(hd: int, dtype) -> int:
    """Shared memory of one block of the instance that takes ``hd``, as
    the built kernel states it."""
    return LIB.load().rwkv6_scan_smem_bytes(hd, _dtype_code(dtype))


def blocks_per_sm(hd: int, dtype) -> int:
    """Blocks of that instance one SM of the current device holds at
    once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    n = LIB.load().rwkv6_scan_blocks_per_sm(hd, _dtype_code(dtype))
    if n < 0:
        LIB.check(-n, "rwkv6_scan occupancy query")
    return n
