"""Phase 8 of ``chip_smoke.py`` (training on the mesh) without the rest of
the script, on one NVIDIA GPU: builds the kernels the training paths
run, holds them against their plain versions at phase 8's per-rank rows
of phase 2 only (``MESH_FLASH_SHAPES`` and the scans' ``mesh_tp`` rows),
then runs ``chip_smoke.mesh_train_phase``; prints a ``timings`` line.

    python3 tools/mesh_train_dev.py       # from the root of a checkout

A shorter loop than the whole script while the mesh training paths
change; the numbers it prints are the script's own functions'.
"""
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

sys.path.insert(0, str(cs.ROOT / "src"))


def main() -> int:
    if not torch.cuda.is_available():
        print("mesh_train_dev: torch finds no CUDA device", file=sys.stderr)
        return 1
    import repro_torch.kernels as kernels
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.rglru_scan import kernel as rg
    from repro_torch.kernels.rwkv6_scan import kernel as rw

    t0 = time.perf_counter()
    cs.log(cs.card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    libs = [fa.LIB, fa.BWD_LIB, rg.LIB, rw.LIB, rw.BWD_LIB]
    nvcc.build_all(libs)
    for lib in libs:
        lib.load()
    sec = {"build": time.perf_counter() - t0}
    t = time.perf_counter()

    def mesh_rows(rows):
        return [r for r in rows if r[0].startswith("mesh_")]

    cs.FLASH_SHAPES = mesh_rows(cs.FLASH_SHAPES)
    cs.FLASH_BWD_SHAPES = mesh_rows(cs.FLASH_BWD_SHAPES)
    cs.RGLRU_SHAPES = mesh_rows(cs.RGLRU_SHAPES)
    cs.RWKV_SHAPES = mesh_rows(cs.RWKV_SHAPES)
    cs.RGLRU_BWD_SHAPES = mesh_rows(cs.RGLRU_BWD_SHAPES)
    cs.RWKV_BWD_SHAPES = mesh_rows(cs.RWKV_BWD_SHAPES)
    cs.flash_phase(kernels)
    cs.flash_bwd_phase(kernels, cs.ptxas_summary(fa.BWD_LIB.build_log))
    cs.rglru_phase(kernels)
    cs.rwkv6_phase(kernels)
    cs.rglru_bwd_phase(kernels)
    cs.rwkv6_bwd_phase(kernels)
    sec["2 mesh rows"] = time.perf_counter() - t
    by_path = cs.mesh_train_phase(sec)
    cs.log("launches", json.dumps(by_path))
    cs.log("timings", json.dumps(dict(seconds=sec,
                                      total_s=time.perf_counter() - t0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
