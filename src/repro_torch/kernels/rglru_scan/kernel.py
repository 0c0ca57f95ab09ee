"""Build and launch the Hopper CUDA ``rglru_scan`` kernel.

Counterpart of ``repro/kernels/rglru_scan/kernel.py`` (the Pallas TPU
kernel); the design note is at the top of ``rglru_scan.cu``. The build
(``nvcc -shared`` at first use, loaded with ``ctypes``) is
``kernels/nvcc.py``'s.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.nvcc import (DTYPE_BFLOAT16, DTYPE_FLOAT32,
                                      CudaLibrary)


def _declare(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rglru_scan_launch.argtypes = [p] * 5 + [ll] * 4 + [i] * 4 + [p]
    lib.rglru_scan_launch.restype = i


LIB = CudaLibrary(Path(__file__).with_name("rglru_scan.cu"), _declare)


def launch(a, b, h0, hs, h_last) -> None:
    """Launch on the current stream of ``hs``'s device. The tensors are
    checked by the caller (``ops.rglru_scan``)."""
    import torch

    lib = LIB.load()
    B, S, R = a.shape
    dtype = DTYPE_BFLOAT16 if a.dtype == torch.bfloat16 else DTYPE_FLOAT32
    with torch.cuda.device(hs.device):
        stream = torch.cuda.current_stream(hs.device).cuda_stream
        err = lib.rglru_scan_launch(
            a.data_ptr(), b.data_ptr(), h0.data_ptr(), hs.data_ptr(),
            h_last.data_ptr(), a.stride(0), a.stride(1), b.stride(0),
            b.stride(1), B, S, R, dtype, stream)
    LIB.check(err, "rglru_scan")
