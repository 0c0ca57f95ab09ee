"""Build and launch the Hopper CUDA ``matern_score`` kernels.

Counterpart of ``repro/kernels/matern_score/kernel.py`` (the Pallas TPU
kernel); the design note is at the top of ``matern_score.cu``, which
holds both entry points: the mean alone (``launch``) and the whole
posterior of a candidate block (``launch_posterior``). The build
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
    lib.matern_posterior_launch.argtypes = [p] * 12 + [i] * 5 + [p]
    lib.matern_posterior_launch.restype = i
    for name, nargs in (("smem_bytes", 1), ("registers", 1),
                        ("blocks_per_sm", 2)):
        fn = getattr(lib, f"matern_posterior_{name}")
        fn.argtypes = [i] * nargs
        fn.restype = i


LIB = CudaLibrary(Path(__file__).with_name("matern_score.cu"), _declare)


def _stream(device):
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def launch(cand, x, alpha, mask, ls, sv, out) -> None:
    """Launch on the current stream of ``out``'s device. The tensors are
    checked by the caller (``ops.matern_score``): contiguous float32 on
    one CUDA device."""
    import torch

    lib = LIB.load()
    S, N, d = cand.shape
    n = x.shape[1]
    with torch.cuda.device(out.device):
        err = lib.matern_score_launch(
            cand.data_ptr(), x.data_ptr(), alpha.data_ptr(),
            mask.data_ptr(), ls.data_ptr(), sv.data_ptr(), out.data_ptr(),
            S, N, n, d, _stream(out.device))
    LIB.check(err, "matern_score")


def launch_posterior(cand, x, alpha, mask, Lt, ls, sv, y_mu, y_sigma, mu,
                     sigma, dmu, nmax, threads) -> None:
    """Launch instance ``nmax`` in blocks of ``threads`` on the current
    stream of ``mu``'s device. ``Lt`` is the lower factor in column-major
    order, contiguous: ``L.mT``. The tensors and the plan are checked and
    chosen by the caller (``ops.matern_posterior``)."""
    import torch

    lib = LIB.load()
    S, N, _ = cand.shape
    n = x.shape[1]
    with torch.cuda.device(mu.device):
        err = lib.matern_posterior_launch(
            *(t.data_ptr() for t in (cand, x, alpha, mask, Lt, ls, sv, y_mu,
                                     y_sigma, mu, sigma, dmu)),
            S, N, n, nmax, threads, _stream(mu.device))
    LIB.check(err, "matern_posterior")


def _query(name: str, *args) -> int:
    v = getattr(LIB.load(), f"matern_posterior_{name}")(*args)
    if v < 0:
        LIB.check(-v, f"matern_posterior {name} query")
    return v


def posterior_build(nmax: int, threads: int) -> dict:
    """The built posterior instance ``nmax``: shared memory a block,
    registers a thread (``cudaFuncGetAttributes``) and the blocks of
    ``threads`` one SM of the current device holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    return dict(smem_bytes=_query("smem_bytes", nmax),
                registers=_query("registers", nmax),
                blocks_per_sm=_query("blocks_per_sm", nmax, threads))
