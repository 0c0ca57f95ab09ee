"""Build and launch the Hopper CUDA ``matern_score`` kernel.

Counterpart of ``repro/kernels/matern_score/kernel.py`` (the Pallas TPU
kernel); the design note is at the top of ``matern_score.cu``.

The source has a plain C interface, so it is compiled by ``nvcc -shared``
into a library loaded with ``ctypes`` (no PyTorch headers, a build of
seconds). The build runs at first use, never at import, into
``build/kernels/`` at the root of the checkout (git ignores it); the
library's name carries a hash of the source and flags, so an edit
rebuilds and concurrent builders never share a half-written file.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SOURCE = Path(__file__).with_name("matern_score.cu")
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
build_log = ""          # nvcc's output of the build this process ran
build_seconds = 0.0     # 0.0 when the library was already built


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the matern_score kernel needs the "
                       "CUDA toolkit to build")


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libmatern_score_{digest}.so"


def build() -> Path:
    """Compile the kernel unless this source is already built."""
    global build_log, build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(SOURCE)], capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {SOURCE.name}:\n"
                           f"{build_log}")
    os.replace(tmp, out)
    return out


def load():
    """The built library, with its C signatures declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.matern_score_launch.argtypes = [p] * 7 + [i] * 4 + [p]
        lib.matern_score_launch.restype = i
        lib.matern_score_error_string.argtypes = [i]
        lib.matern_score_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch(cand, x, alpha, mask, ls, sv, out) -> None:
    """Launch on the current stream of ``out``'s device. The tensors are
    checked by the caller (``ops.matern_score``): contiguous float32 on
    one CUDA device."""
    import torch

    lib = load()
    S, N, d = cand.shape
    n = x.shape[1]
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.matern_score_launch(
            cand.data_ptr(), x.data_ptr(), alpha.data_ptr(),
            mask.data_ptr(), ls.data_ptr(), sv.data_ptr(), out.data_ptr(),
            S, N, n, d, stream)
    if err:
        raise RuntimeError("matern_score launch failed: "
                           + lib.matern_score_error_string(err).decode())
