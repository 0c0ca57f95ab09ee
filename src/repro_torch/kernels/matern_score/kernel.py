"""Build and launch the Hopper CUDA ``matern_score`` kernel.

Counterpart of ``repro/kernels/matern_score/kernel.py`` (the Pallas TPU
kernel); the design note is at the top of ``matern_score.cu``. The build
(``nvcc -shared`` at first use, loaded with ``ctypes``) is
``kernels/nvcc.py``'s.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.nvcc import CudaLibrary


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.matern_score_launch.argtypes = [p] * 7 + [i] * 4 + [p]
    lib.matern_score_launch.restype = i


LIB = CudaLibrary(Path(__file__).with_name("matern_score.cu"), _declare)


def launch(cand, x, alpha, mask, ls, sv, out) -> None:
    """Launch on the current stream of ``out``'s device. The tensors are
    checked by the caller (``ops.matern_score``): contiguous float32 on
    one CUDA device."""
    import torch

    lib = LIB.load()
    S, N, d = cand.shape
    n = x.shape[1]
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.matern_score_launch(
            cand.data_ptr(), x.data_ptr(), alpha.data_ptr(),
            mask.data_ptr(), ls.data_ptr(), sv.data_ptr(), out.data_ptr(),
            S, N, n, d, stream)
    LIB.check(err, "matern_score")
