"""Phase 5 of ``chip_smoke.py`` for the pool's other LMs without the rest
of the script, on one NVIDIA GPU: builds the forward kernels, runs phase
2's rows of those models (``flash_attention`` and ``decode_attention``
at their heads, the posterior at their serving runs' (S, N, n)), then
``chip_smoke.model_phase`` for each arch named (default: the six of
``ARCHS``), going on to the next where one fails; prints a ``timings``
line and exits non-zero if any phase failed.

    python3 tools/pool_serving_dev.py [ARCH ...]   # from a checkout's root

A shorter loop than the whole script while these paths change; the
numbers it prints are the script's own functions'.
"""
import json
import sys
import time
import traceback
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

sys.path.insert(0, str(cs.ROOT / "src"))

ARCHS = ("deepseek-7b", "h2o-danube-3-4b", "starcoder2-15b",
         "musicgen-large", "internvl2-26b", "kimi-k2-1t-a32b")
# phase 2's rows of these models, by name prefix
ROW_PREFIXES = ("deepseek_", "danube_", "starcoder2_", "musicgen_",
                "internvl2_", "kimi_")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("pool_serving_dev: torch finds no CUDA device",
              file=sys.stderr)
        return 1
    import repro_torch.kernels as kernels
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.decode_attention import kernel as da
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.matern_score import kernel as ms

    archs = argv or ARCHS
    t0 = time.perf_counter()
    cs.log(cs.card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    libs = [ms.LIB, fa.LIB, da.LIB]
    nvcc.build_all(libs)
    for lib in libs:
        lib.load()
    sec = {"build": time.perf_counter() - t0}
    failed = []

    def timed(name, fn, *a):
        t = time.perf_counter()
        try:
            fn(*a)
        except Exception:                # report, go on to the next
            traceback.print_exc()
            failed.append(name)
        sec[name] = time.perf_counter() - t

    def ours(shapes):
        return [r for r in shapes if r[0].startswith(ROW_PREFIXES)]

    cs.FLASH_SHAPES[:] = ours(cs.FLASH_SHAPES)
    cs.DECODE_SHAPES[:] = ours(cs.DECODE_SHAPES)
    timed("2 flash_attention", cs.flash_phase, kernels)
    timed("2 decode_attention", cs.decode_phase, kernels)
    serve_rows = [r for r in cs.main_rows() if r not in cs.MAIN_ROWS]
    timed("2 matern_posterior", cs.posterior_phase, kernels, serve_rows,
          serve_rows)
    for run in cs.MODEL_RUNS:
        if run.arch in archs:
            timed(f"5 {run.arch}", cs.model_phase, kernels, run)
    cs.log("timings", json.dumps(dict(seconds=sec, failed=failed,
                                      total_s=time.perf_counter() - t0)))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
