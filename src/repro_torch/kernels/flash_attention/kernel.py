"""Build and launch the Hopper CUDA ``flash_attention`` kernel.

Counterpart of ``repro/kernels/flash_attention/kernel.py`` (the Pallas
TPU kernel); the design note is at the top of ``flash_attention.cu``.
The build (``nvcc -shared`` at first use, loaded with ``ctypes``) is
``kernels/nvcc.py``'s.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.nvcc import (DTYPE_BFLOAT16, DTYPE_FLOAT32,
                                      CudaLibrary)


def _declare(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_launch.argtypes = ([p] * 4 + [ll] * 12 + [i] * 9
                                           + [p])
    lib.flash_attention_launch.restype = i


LIB = CudaLibrary(Path(__file__).with_name("flash_attention.cu"), _declare)


def launch(q, k, v, out, causal: bool, window: int) -> None:
    """Launch on the current stream of ``out``'s device. The tensors are
    checked by the caller (``ops.flash_attention``): one dtype (float32
    or bfloat16) on one CUDA device, contiguous head dims."""
    import torch

    lib = LIB.load()
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    dtype = DTYPE_BFLOAT16 if q.dtype == torch.bfloat16 else DTYPE_FLOAT32
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *strides, B, Sq, Skv, Hq, Hkv, hd, int(causal), int(window),
            dtype, stream)
    LIB.check(err, "flash_attention")
