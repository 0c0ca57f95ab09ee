"""Build and launch the Hopper CUDA ``decode_attention`` kernel.

Counterpart of ``repro/kernels/decode_attention/kernel.py`` (the Pallas
TPU kernel); the design note is at the top of ``decode_attention.cu``.
The build (``nvcc -shared`` at first use, loaded with ``ctypes``) is
``kernels/nvcc.py``'s.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.nvcc import (DTYPE_BFLOAT16, DTYPE_FLOAT32,
                                      CudaLibrary)

SLOTS_PER_TILE = 64       # kBT in the source
SMEM_LIMIT = 232448       # bytes of shared memory a block may use


def smem_bytes(hd: int, group: int) -> int:
    """Shared memory of one block, as ``smem_bytes`` in the source."""
    return (4 * (2 * SLOTS_PER_TILE * (hd + 1) + 2 * group * hd
                 + group * SLOTS_PER_TILE + 3 * group)
            + 4 * SLOTS_PER_TILE)


def _declare(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.decode_attention_launch.argtypes = [p] * 6 + [ll] * 8 + [i] * 7 + [p]
    lib.decode_attention_launch.restype = i


LIB = CudaLibrary(Path(__file__).with_name("decode_attention.cu"), _declare)


def launch(q, k, v, kv_pos, q_pos, out, window: int) -> None:
    """Launch on the current stream of ``out``'s device. The tensors are
    checked by the caller (``ops.decode_attention``)."""
    import torch

    lib = LIB.load()
    B, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    strides = [q.stride(0), q.stride(1), *k.stride()[:3], *v.stride()[:3]]
    dtype = DTYPE_BFLOAT16 if q.dtype == torch.bfloat16 else DTYPE_FLOAT32
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_pos.data_ptr(),
            q_pos.data_ptr(), out.data_ptr(), *strides, B, T, Hq, Hkv, hd,
            int(window), dtype, stream)
    LIB.check(err, "decode_attention")
