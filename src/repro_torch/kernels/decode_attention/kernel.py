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

SUB_TILE = 32             # kSub in the source: slots per sub-tile
SMEM_LIMIT = 232448       # bytes of shared memory a block may use


def instance_width(hd: int) -> int:
    """The head-dim width of the instance that runs ``hd``."""
    return 64 if hd <= 64 else 128 if hd <= 128 else 256


def smem_bytes(hd: int, group: int, itemsize: int) -> int:
    """Shared memory of one block, as ``smem_bytes`` in the source: a
    sub-tile of K and of V in the input type, then q and the accumulator
    (group x width), the scores (group x 32) and m, l and the rescale
    factor in float32."""
    width = instance_width(hd)
    return (2 * SUB_TILE * width * itemsize
            + 4 * (2 * group * width + group * SUB_TILE + 3 * group))


def _declare(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.decode_attention_launch.argtypes = ([p] * 9 + [ll] * 8 + [i] * 9
                                            + [p])
    lib.decode_attention_launch.restype = i


LIB = CudaLibrary(Path(__file__).with_name("decode_attention.cu"), _declare)

# float32 partials of the splits, per (device, stream), grown as needed:
# calls on one stream run in order, so one buffer serves them all
_SCRATCH: dict = {}


def scratch(device, stream: int, n_float: int):
    import torch

    part = _SCRATCH.get((device, stream))
    if part is None or part.numel() < n_float:
        part = torch.empty(n_float, dtype=torch.float32, device=device)
        _SCRATCH[(device, stream)] = part
    return part


def launch(q, k, v, kv_pos, q_pos, out, window: int, n_split: int,
           chunk: int, lse=None) -> None:
    """Launch on the current stream of ``out``'s device, ``n_split``
    splits of ``chunk`` slots, then their merge, which also writes each
    row's log-sum-exp into ``lse`` (B, Hq) float32 when one is given. The
    tensors are checked by the caller (``ops.decode_attention``)."""
    import torch

    lib = LIB.load()
    B, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    strides = [q.stride(0), q.stride(1), *k.stride()[:3], *v.stride()[:3]]
    dtype = DTYPE_BFLOAT16 if q.dtype == torch.bfloat16 else DTYPE_FLOAT32
    cells = B * Hkv * n_split
    n_acc = cells * Hq // Hkv * hd
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        part = scratch(out.device, stream, n_acc + cells * 2 * Hq // Hkv)
        err = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_pos.data_ptr(),
            q_pos.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), part.data_ptr(),
            part.data_ptr() + 4 * n_acc, *strides, B, T, Hq, Hkv, hd,
            int(window), n_split, chunk, dtype, stream)
    LIB.check(err, "decode_attention")
