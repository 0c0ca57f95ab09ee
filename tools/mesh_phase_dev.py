"""Phase 7 of ``chip_smoke.py`` (the mesh) without the rest of the script,
on one NVIDIA GPU: builds the forward kernels, runs phase 2's
``decode_attention`` rows (with and without the log-sum-exp), the two
whole runs of phase 4b that phase 7a shards, the greedy generations
(and float32 logits) of phase 5 that phase 7b is held to,
then ``chip_smoke.mesh_phase``; prints a ``timings`` line.

    python3 tools/mesh_phase_dev.py       # from the root of a checkout

A shorter loop than the whole script while the mesh paths change; the
numbers it prints are the script's own functions'.
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
        print("mesh_phase_dev: torch finds no CUDA device", file=sys.stderr)
        return 1
    import repro_torch.core as core
    import repro_torch.kernels as kernels
    from repro_torch.configs import get_config
    from repro_torch.core.engine_config import EngineConfig
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.decode_attention import kernel as da
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.matern_score import kernel as ms
    from repro_torch.kernels.rglru_scan import kernel as rg
    from repro_torch.kernels.rwkv6_scan import kernel as rw

    t0 = time.perf_counter()
    cs.log(cs.card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    libs = [ms.LIB, fa.LIB, da.LIB, rg.LIB, rw.LIB]
    nvcc.build_all(libs)
    for lib in libs:
        lib.load()
    sec = {"build": time.perf_counter() - t0}
    t = time.perf_counter()
    rows = cs.decode_phase(kernels)
    cs.decode_lse_phase(kernels, rows)
    sec["2 decode"] = time.perf_counter() - t
    t = time.perf_counter()
    want = json.loads(cs.WHOLERUN_EXPECTED.read_text())["hetero"]
    cs.WHOLERUN_RESULTS["grid"] = cs.plain_results(
        core.WholeRunBayesSplitEdge(cs.batched_scenarios(core)).run())
    cs.WHOLERUN_RESULTS["hetero"] = cs.plain_results(
        core.WholeRunBayesSplitEdge(core.make_hetero_scenarios(
            seeds=want["seeds"], budgets=want["budgets"],
            archs=want["archs"]), EngineConfig(warm_start=False)).run())
    sec["4b"] = time.perf_counter() - t
    for arch in dict.fromkeys(m[1] for m in cs.MESH_RUNS):
        t = time.perf_counter()
        cs.GENERATED[arch] = cs.mesh_generated(get_config(arch))
        sec[f"5 {arch}"] = time.perf_counter() - t
    cs.mesh_phase(sec)
    cs.log("timings", json.dumps(dict(seconds=sec,
                                      total_s=time.perf_counter() - t0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
