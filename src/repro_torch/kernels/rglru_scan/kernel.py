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
    lib.rglru_scan_bwd_launch.argtypes = [p] * 8 + [ll] * 4 + [i] * 3 + [p]
    lib.rglru_scan_bwd_launch.restype = i
    for name in ("rglru_scan_chunk_steps", "rglru_scan_chunks"):
        getattr(lib, name).argtypes = [i]
        getattr(lib, name).restype = i
    for name in ("rglru_scan_smem_bytes", "rglru_scan_blocks_per_sm"):
        getattr(lib, name).argtypes = [i, i]
        getattr(lib, name).restype = i


LIB = CudaLibrary(Path(__file__).with_name("rglru_scan.cu"), _declare)


def launch(a, b, h0, hs, h_last) -> None:
    """Launch on the current stream of ``hs``'s device. The tensors are
    checked by the caller (``ops.rglru_scan``)."""
    import torch

    lib = LIB.load()
    B, S, R = a.shape
    dtype = _dtype_code(a.dtype)
    with torch.cuda.device(hs.device):
        stream = torch.cuda.current_stream(hs.device).cuda_stream
        err = lib.rglru_scan_launch(
            a.data_ptr(), b.data_ptr(), h0.data_ptr(), hs.data_ptr(),
            h_last.data_ptr(), a.stride(0), a.stride(1), b.stride(0),
            b.stride(1), B, S, R, dtype, stream)
    LIB.check(err, "rglru_scan")


def launch_bwd(a, h0, hs, dhs, dh_last, da, db, dh0) -> None:
    """Launch the float32 backward on the current stream of ``hs``'s
    device; ``dh_last`` may be None (zero). The tensors are checked by
    the caller (``ops.rglru_scan_bwd``)."""
    import torch

    lib = LIB.load()
    B, S, R = a.shape
    with torch.cuda.device(hs.device):
        stream = torch.cuda.current_stream(hs.device).cuda_stream
        err = lib.rglru_scan_bwd_launch(
            a.data_ptr(), h0.data_ptr(), hs.data_ptr(), dhs.data_ptr(),
            None if dh_last is None else dh_last.data_ptr(), da.data_ptr(),
            db.data_ptr(), dh0.data_ptr(), a.stride(0), a.stride(1),
            dhs.stride(0), dhs.stride(1), B, S, R, stream)
    LIB.check(err, "rglru_scan_bwd")


def _dtype_code(dtype) -> int:
    import torch

    return DTYPE_BFLOAT16 if dtype == torch.bfloat16 else DTYPE_FLOAT32


def _query(name: str, *args) -> int:
    n = getattr(LIB.load(), f"rglru_scan_{name}")(*args)
    if n < 0:
        LIB.check(-n, f"rglru_scan {name} query")
    return n


def launch_plan(S: int, dtype) -> dict:
    """What the built kernel launches for S steps: steps a chunk, chunks
    a piece, shared memory a block, and the blocks one SM of the current
    device holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    code = _dtype_code(dtype)
    return dict(chunk=_query("chunk_steps", S), chunks=_query("chunks", S),
                smem_bytes=_query("smem_bytes", S, code),
                blocks_per_sm=_query("blocks_per_sm", S, code))
