"""Build a CUDA source with a plain C interface into a shared library and
load it with ``ctypes``. Every kernel of the port goes through here.

The sources include no PyTorch header, so ``nvcc -shared`` builds each in
seconds. A build runs at first use, never at import, into
``build/kernels/`` at the root of the checkout (git ignores it). The
library's name carries a hash of the source and the flags, so an edit
rebuilds, and a build writes a temporary file that is renamed into place,
so two processes building at once never load a half-written library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Iterable

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of the C entry points that take more than one type
DTYPE_FLOAT32, DTYPE_BFLOAT16 = 0, 1


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the port's kernels need the CUDA "
                       "toolkit to build")


class CudaLibrary:
    """One ``.cu`` source, built once and loaded once per process.

    ``declare(lib)`` sets the ``argtypes``/``restype`` of the library's
    launch functions; every library also exports
    ``<stem>_error_string(int)``, declared here. ``defines`` are passed
    to nvcc as ``-D`` flags (constants that Python code shares with the
    source). After a build,
    ``build_log`` holds nvcc's output (``-Xptxas -v``: registers, shared
    memory, spills) and ``build_seconds`` its wall time; both stay empty
    when the library was already built.
    """

    def __init__(self, source: Path, declare: Callable,
                 defines: dict | None = None):
        self.source = Path(source)
        self.declare = declare
        self.flags = NVCC_FLAGS + tuple(
            f"-D{k}={v}" for k, v in (defines or {}).items())
        self.build_log = ""
        self.build_seconds = 0.0
        self._lib = None

    @property
    def name(self) -> str:
        return self.source.stem

    def library_path(self) -> Path:
        digest = hashlib.sha1(self.source.read_bytes()
                              + " ".join(self.flags).encode()).hexdigest()
        return BUILD_DIR / f"lib{self.name}_{digest[:12]}.so"

    def build(self) -> Path:
        """Compile the source unless this version is already built."""
        out = self.library_path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc(), *self.flags, "-o", str(tmp),
                               str(self.source)], capture_output=True,
                              text=True)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {self.source.name}:\n"
                               f"{self.build_log}")
        os.replace(tmp, out)
        return out

    def load(self):
        """The built library, with its C signatures declared."""
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            err = getattr(lib, f"{self.name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self.declare(lib)
            self._lib = lib
        return self._lib

    def check(self, err: int, what: str) -> None:
        """Raise if a launch returned a CUDA error code."""
        if err:
            msg = getattr(self.load(), f"{self.name}_error_string")(err)
            raise RuntimeError(f"{what} launch failed: {msg.decode()}")


def build_all(libraries: Iterable[CudaLibrary]) -> None:
    """Build every library at once, one nvcc process per source."""
    libs = list(libraries)
    with ThreadPoolExecutor(max_workers=max(1, len(libs))) as pool:
        for f in [pool.submit(lib.build) for lib in libs]:
            f.result()
