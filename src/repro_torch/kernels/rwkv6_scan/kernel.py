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
from repro_torch.kernels.rwkv6_scan.ref import CKPT_STEPS

MAX_HEAD_DIM = 256        # the largest instance: 8 groups of 32 rows
SMEM_LIMIT = 113 * 1024   # shared bytes a block, so that two fit an SM
BWD_MAX_THREADS = 160     # compute threads a block of the row kernel
BWD_REG_FLOATS = 40       # registers a thread gives a span's states


def _declare(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rwkv6_scan_launch.argtypes = [p] * 9 + [ll] * 12 + [i] * 5 + [p]
    lib.rwkv6_scan_launch.restype = i
    lib.rwkv6_scan_bwd_dv_launch.argtypes = [p] * 8 + [ll] * 12 + [i] * 4 \
        + [p]
    lib.rwkv6_scan_bwd_dv_launch.restype = i
    for name in ("rwkv6_scan_smem_bytes", "rwkv6_scan_blocks_per_sm"):
        getattr(lib, name).argtypes = [i, i]
        getattr(lib, name).restype = i


def _declare_bwd(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rwkv6_scan_bwd_rows_launch.argtypes = [p] * 13 + [i] * 4 + [p]
    lib.rwkv6_scan_bwd_rows_launch.restype = i
    for name in ("rwkv6_scan_bwd_smem_bytes", "rwkv6_scan_bwd_threads",
                 "rwkv6_scan_bwd_blocks_per_sm"):
        getattr(lib, name).argtypes = [i]
        getattr(lib, name).restype = i
    lib.rwkv6_scan_bwd_lanes.argtypes = []
    lib.rwkv6_scan_bwd_lanes.restype = i


# the forward saves the state every CKPT_STEPS steps and the backward
# walks those spans: both sources take the one constant, and the limit on
# a block's shared memory, from here; the row kernel its sizing too, which
# ops.bwd_plan reads from here as well
_DEFINES = {"RWKV6_CKPT_STEPS": CKPT_STEPS,
            "RWKV6_SMEM_LIMIT": SMEM_LIMIT}
LIB = CudaLibrary(Path(__file__).with_name("rwkv6_scan.cu"), _declare,
                  _DEFINES)
BWD_LIB = CudaLibrary(Path(__file__).with_name("rwkv6_scan_bwd.cu"),
                      _declare_bwd,
                      {**_DEFINES, "RWKV6_BWD_MAX_THREADS": BWD_MAX_THREADS,
                       "RWKV6_BWD_REG_FLOATS": BWD_REG_FLOATS})


def _stream(device):
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def launch(r, k, v, logw, u, s0, o, s_out, ckpt=None) -> None:
    """Launch on the current stream of ``o``'s device; ``ckpt`` (float32
    only), when given, receives the state before every ``CKPT_STEPS``-th
    step. The tensors are checked by the caller (``ops.rwkv6_scan``)."""
    import torch

    lib = LIB.load()
    B, S, H, hd = r.shape
    strides = [s for t in (r, k, v, logw) for s in t.stride()[:3]]
    dtype = _dtype_code(r.dtype)
    with torch.cuda.device(o.device):
        err = lib.rwkv6_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), s0.data_ptr(), o.data_ptr(), s_out.data_ptr(),
            None if ckpt is None else ckpt.data_ptr(), *strides, B, S, H,
            hd, dtype, _stream(o.device))
    LIB.check(err, "rwkv6_scan")


def launch_bwd(r, k, v, logw, u, ckpt, do, ds_last, dr, dk, dv, dlogw,
               du_part, du, ds0) -> None:
    """The backward, float32, on the current stream of ``do``'s device:
    dv and ds0 by the forward's body in reverse time (``LIB``), then dr,
    dk, dlogw and du by the row kernel and the batch sum
    (``launch_bwd_rows``). The tensors are contiguous and checked by the
    caller (``ops.rwkv6_scan_bwd``)."""
    import torch

    lib = LIB.load()
    B, S, H, hd = r.shape
    strides = [s for t in (k, r, do, logw) for s in t.stride()[:3]]
    with torch.cuda.device(do.device):
        err = lib.rwkv6_scan_bwd_dv_launch(
            k.data_ptr(), r.data_ptr(), do.data_ptr(), logw.data_ptr(),
            u.data_ptr(), ds_last.data_ptr(), dv.data_ptr(), ds0.data_ptr(),
            *strides, B, S, H, hd, _stream(do.device))
    LIB.check(err, "rwkv6_scan_bwd (dv)")
    launch_bwd_rows(r, k, v, logw, u, ckpt, do, ds_last, dr, dk, dlogw,
                    du_part, du)


def launch_bwd_rows(r, k, v, logw, u, ckpt, do, ds_last, dr, dk, dlogw,
                    du_part, du) -> None:
    """The row kernel (dr, dk, dlogw, du's partials) and du's batch sum
    alone (``BWD_LIB``); contiguous float32 tensors, as ``launch_bwd``
    takes them."""
    import torch

    bwd = BWD_LIB.load()
    B, S, H, hd = r.shape
    with torch.cuda.device(do.device):
        err = bwd.rwkv6_scan_bwd_rows_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), ckpt.data_ptr(), do.data_ptr(), ds_last.data_ptr(),
            dr.data_ptr(), dk.data_ptr(), dlogw.data_ptr(),
            du_part.data_ptr(), du.data_ptr(), B, S, H, hd,
            _stream(do.device))
    BWD_LIB.check(err, "rwkv6_scan_bwd (rows)")


def bwd_build(hd: int) -> dict:
    """What the built row kernel's instance for ``hd`` takes: lanes a
    row, threads and shared bytes of a block, and the blocks one SM of
    the current device holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    lib = BWD_LIB.load()
    per_sm = lib.rwkv6_scan_bwd_blocks_per_sm(hd)
    if per_sm < 0:
        BWD_LIB.check(-per_sm, "rwkv6_scan_bwd occupancy query")
    return dict(lanes=lib.rwkv6_scan_bwd_lanes(),
                threads=lib.rwkv6_scan_bwd_threads(hd),
                smem_bytes=lib.rwkv6_scan_bwd_smem_bytes(hd),
                blocks_per_sm=per_sm)


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
