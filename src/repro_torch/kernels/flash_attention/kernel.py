"""Build and launch the Hopper CUDA ``flash_attention`` kernels: the
forward (``flash_attention.cu``) and its backward
(``flash_attention_bwd.cu``).

Counterpart of ``repro/kernels/flash_attention/kernel.py`` (the Pallas
TPU kernel, forward only); the design notes are at the top of each
source. The build (``nvcc -shared`` at first use, loaded with
``ctypes``) is ``kernels/nvcc.py``'s.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.nvcc import (DTYPE_BFLOAT16, DTYPE_FLOAT32,
                                      CudaLibrary)


def _declare_plan(fn) -> None:
    i, pi = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [i, i, pi, pi]
    fn.restype = i


def _declare(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_launch.argtypes = ([p] * 5 + [ll] * 12 + [i] * 9
                                           + [p])
    lib.flash_attention_launch.restype = i
    _declare_plan(lib.flash_attention_occupancy)


def _declare_bwd(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_bwd_launch.argtypes = ([p] * 12
                                               + [ctypes.POINTER(
                                                   ctypes.c_longlong)]
                                               + [i] * 9 + [p])
    lib.flash_attention_bwd_launch.restype = i
    _declare_plan(lib.flash_attention_bwd_occupancy)


LIB = CudaLibrary(Path(__file__).with_name("flash_attention.cu"), _declare)
BWD_LIB = CudaLibrary(Path(__file__).with_name("flash_attention_bwd.cu"),
                      _declare_bwd)


def _dtype_code(dtype) -> int:
    import torch

    return DTYPE_BFLOAT16 if dtype == torch.bfloat16 else DTYPE_FLOAT32


def strides(t) -> list:
    """The batch, sequence and head strides of ``t`` as the kernels take
    them: 0 for a dim of size 1, whose stride PyTorch leaves free (a
    contiguous tensor may carry any there) and the kernels never use."""
    return [s if n > 1 else 0 for s, n in zip(t.stride()[:3], t.shape[:3])]


def launch(q, k, v, out, causal: bool, window: int, lse=None) -> None:
    """Launch on the current stream of ``out``'s device. The tensors are
    checked by the caller (``ops``): one dtype (float32 or bfloat16) on
    one CUDA device, contiguous head dims; ``lse``, when given, float32
    (B, Hq, Sq) contiguous."""
    import torch

    lib = LIB.load()
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    steps = [s for t in (q, k, v, out) for s in strides(t)]
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            *steps, B, Sq, Skv, Hq, Hkv, hd, int(causal), int(window),
            _dtype_code(q.dtype), stream)
    LIB.check(err, "flash_attention")


def launch_bwd(q, k, v, out, dout, lse, dq, dk, dv, causal: bool,
               window: int) -> None:
    """Launch the backward's three CUDA kernels on the current stream of
    ``dq``'s device, with float32 scratch from ``torch.empty``: D (B, Hq,
    Sq) and the per-q-head dk and dv partials (B, Skv, Hq, hd) that the
    last kernel sums over each group. Checked by the caller
    (``ops.flash_attention_bwd``)."""
    import torch

    lib = BWD_LIB.load()
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    f32 = dict(dtype=torch.float32, device=q.device)
    dsum = torch.empty(B, Hq, Sq, **f32)
    dkp = torch.empty(B, Skv, Hq, hd, **f32)
    dvp = torch.empty(B, Skv, Hq, hd, **f32)
    steps = (ctypes.c_longlong * 24)(*[
        s for t in (q, k, v, out, dout, dq, dk, dv) for s in strides(t)])
    with torch.cuda.device(dq.device):
        stream = torch.cuda.current_stream(dq.device).cuda_stream
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dkp.data_ptr(),
            dvp.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            steps, B, Sq, Skv, Hq, Hkv, hd, int(causal), int(window),
            _dtype_code(q.dtype), stream)
    BWD_LIB.check(err, "flash_attention_bwd")


def occupancy(hd: int, dtype, backward: bool = False) -> dict:
    """The launch plan of the instance that runs head dim ``hd`` in
    ``dtype`` (the forward's kernel, or the backward's dq + dk/dv kernel):
    its dynamic shared memory in bytes and the blocks of it that fit an
    SM, from the CUDA occupancy calculator on the current device."""
    library = BWD_LIB if backward else LIB
    fn = getattr(library.load(), f"{library.name}_occupancy")
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    err = fn(hd, _dtype_code(dtype), ctypes.byref(smem),
             ctypes.byref(blocks))
    library.check(err, f"{library.name} occupancy")
    return dict(smem_bytes=smem.value, blocks_per_sm=blocks.value)
