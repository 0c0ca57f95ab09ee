#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which raises on failure (non-zero exit):

1. setup: the card's name and power limit, torch/CUDA versions, TF32 off,
   and the build of every kernel from the sources in the checkout;
2. each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, with error and CUDA-event times;
3. the sequential engine, ``BayesSplitEdge(default_vgg19_problem(),
   budget=20).run(seed=0)``, must reach 87.5 % at split layer 7;
4. the batched engine on the 16-scenario VGG19 grid (seeds 0-3 x gain
   offsets 0/-2 dB x budgets 20/28) must match the per-scenario
   accuracies recorded in ``benchmarks/artifacts/BENCH_bo_engine.json``.

Launch counters are zeroed before phases 3 and 4 and read after them:
each kernel of the path must have launched. The last line is the JSON
``{"ok": true, "device": {...}}``; a JSON line before it lists every
kernel with its launches, error, times and bound. Exits non-zero without
a CUDA device, and outside a checkout (it imports ``src/repro_torch``).
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
RTOL = ATOL = 1e-5        # kernel vs plain: the summation order differs
# published H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor
# cores and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# sqrt and exp run on the special-function units: 16 results per clock
# per SM on compute capability 9.0 against 128 f32 FMAs (256 operations)
# per clock per SM (CUDA C++ Programming Guide, arithmetic instruction
# throughput), so 1/16 of the f32 operation peak
PEAK_SFU_PER_S = PEAK_F32_FLOPS / 16
MAIN_N = 64 * 64 + 37 + 45          # grid + VGG19 boundary + local slots
SHAPES = ([(16, MAIN_N, n, 2) for n in (16, 32, 48, 64)]
          + [(256, MAIN_N, 64, 2)])            # 256: a serving-pool width
MAIN_SHAPE = (16, MAIN_N, 64, 2)
SLEEP_CYCLES = 50_000_000           # keeps the queue full while timing


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# phase 2: kernel against plain
# --------------------------------------------------------------------------


def score_inputs(S, N, n, d, seed=0):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device="cuda")

    return (t(rng.random((S, N, d))), t(rng.random((S, n, d))),
            t(rng.standard_normal((S, n))), t(rng.random((S, n)) < 0.8),
            t(0.1 + rng.random(S)), t(0.5 + rng.random(S)))


def matern_bound(S, N, n, d):
    """Least time on an H100 for one call, and which term sets it: the
    larger of the bytes (each input read once, the output written once)
    at the HBM rate, the f32 operations at the f32 peak, and the sqrt and
    exp at the special-function rate.

    Per (candidate, point) pair the function needs 3d + 10 f32 operations
    (an FMA counts 2): d subtracts, d multiplies and d - 1 adds for the
    squared distance; the max with 1e-16; r = sqrt(.) * (1/ls) and
    r^2 = d2 * (1/ls^2), one multiply each; 1 + sqrt5 r + (5/3) r^2 as
    two FMAs (4); the exp argument (1); polynomial times exp (1); and the
    accumulate w_i * k + acc as one FMA (2). Work that does not depend on
    the candidate is done once: w_i = mask_i * alpha_i * sv per point
    (2 per point) and 1/ls, 1/ls^2 per scenario (2 per scenario). Each
    pair also needs one sqrt and one exp, which the special-function
    units run."""
    nbytes = 4 * (S * N * d + S * n * d + 2 * S * n + 2 * S + S * N)
    pairs = S * N * n
    flops = pairs * (3 * d + 10) + 2 * S * n + 2 * S
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = max(flops / PEAK_F32_FLOPS, 2 * pairs / PEAK_SFU_PER_S)
    return (1e3 * max(t_bytes, t_ops),
            "operations" if t_ops >= t_bytes else "bytes",
            dict(bytes_ms=1e3 * t_bytes, f32_ms=1e3 * flops / PEAK_F32_FLOPS,
                 sfu_ms=1e3 * 2 * pairs / PEAK_SFU_PER_S))


def time_calls(fn, args, inner=20):
    """Device ms per call: CUDA events around ``inner`` back-to-back calls
    queued behind a sleep kernel, so host launch cost leaves no gaps."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(inner):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / inner


def kernel_phase(matern_score, matern_score_ref):
    rows = []
    for S, N, n, d in SHAPES:
        args = score_inputs(S, N, n, d, seed=S + n)
        got = matern_score(*args)
        ref = matern_score_ref(*args)
        torch.cuda.synchronize()
        diff = (got - ref).abs()
        abs_err = float(diff.max())
        rel_err = float((diff / ref.abs().clamp(min=1e-30)).max())
        ok = bool(torch.allclose(got, ref, rtol=RTOL, atol=ATOL))
        for fn in (matern_score_ref, matern_score):      # warm-up
            time_calls(fn, args, inner=3)
        ms, plain = [], []
        for _ in range(25):                              # in turns
            plain.append(time_calls(matern_score_ref, args))
            ms.append(time_calls(matern_score, args))
        bound_ms, bound_by, terms = matern_bound(S, N, n, d)
        row = dict(S=S, N=N, n=n, d=d, max_abs_err=abs_err,
                   max_rel_err=rel_err, allclose=ok,
                   ms=statistics.median(ms), plain_ms=statistics.median(plain),
                   bound_ms=bound_ms, bound_by=bound_by, bound_terms=terms)
        log("matern_score", json.dumps(row))
        if not ok:
            raise AssertionError(f"matern_score disagrees with its plain "
                                 f"version at {(S, N, n, d)}: max abs err "
                                 f"{abs_err}, rtol/atol {RTOL}/{ATOL}")
        rows.append(row)
    return rows


# --------------------------------------------------------------------------
# phases 3 and 4: the main path
# --------------------------------------------------------------------------


def sequential_phase(core, kernels):
    pb = core.default_vgg19_problem()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = core.BayesSplitEdge(pb, budget=20).run(seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    layer, p_w = pb.denormalize(res.best_a)
    log("sequential", json.dumps(dict(
        wall_s=wall, best_accuracy=res.best_accuracy, layer=layer, p_w=p_w,
        n_evals=res.n_evals, launches=counts)))
    if res.best_accuracy < 87.5 - 1e-6 or layer != 7:
        raise AssertionError(f"sequential run missed the optimum: "
                             f"{res.best_accuracy} at layer {layer}")
    return counts


def batched_scenarios(core):
    return core.make_vgg19_scenarios(seeds=(0, 1, 2, 3),
                                     gain_offsets_db=(0.0, -2.0),
                                     budgets=(20, 28))[:16]


def batched_phase(core, kernels):
    expect = json.loads((ROOT / "benchmarks" / "artifacts"
                         / "BENCH_bo_engine.json").read_text())
    expect = expect["accuracies"]["batched"]
    scs = batched_scenarios(core)
    iters = []
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = core.BatchedBayesSplitEdge(scs).run(
        on_iteration=lambda i, c: iters.append(i))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    accs = [r.best_accuracy for r in res]
    feas = [r.best_a is not None for r in res]
    log("batched", json.dumps(dict(wall_s=wall, iterations=len(iters),
                                   launches=counts, accuracies=accs,
                                   feasible=feas,
                                   n_evals=[r.n_evals for r in res])))
    if accs != expect or feas != [a > 0 for a in expect]:
        raise AssertionError(f"batched accuracies {accs} (feasible {feas}) "
                             f"!= recorded {expect}")
    if counts["matern_score"] != len(iters):
        raise AssertionError(f"matern_score launched {counts} times in "
                             f"{len(iters)} batched iterations")
    return counts, wall, len(iters)


def breakdown_phase(core):
    """A second batched run with the device synchronised around each part
    of an iteration: GP fit, block scoring (the kernel and the sigma/grad
    terms), refinement, and the host bookkeeping that is left."""
    from repro_torch.core import acquisition, batch_bo, gp

    spent = dict(gp_fit=0.0, block_scoring=0.0, maximize=0.0)

    def timed(name, fn):
        def wrap(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            return out
        return wrap

    with mock.patch.object(gp, "fit_batch", timed("gp_fit", gp.fit_batch)), \
         mock.patch.object(acquisition, "block_scores",
                           timed("block_scoring", acquisition.block_scores)), \
         mock.patch.object(batch_bo, "maximize_batch",
                           timed("maximize", batch_bo.maximize_batch)):
        t0 = time.perf_counter()
        core.BatchedBayesSplitEdge(batched_scenarios(core)).run()
        total = time.perf_counter() - t0
    parts = dict(gp_fit=spent["gp_fit"], block_scoring=spent["block_scoring"],
                 refinement=spent["maximize"] - spent["block_scoring"])
    parts["host_bookkeeping"] = total - sum(parts.values())
    share = {k: v / total for k, v in parts.items()}
    log("batched_breakdown", json.dumps(dict(wall_s=total, seconds=parts,
                                             share=share)))
    return share


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core as core
    import repro_torch.kernels as kernels
    from repro_torch.kernels.matern_score import kernel as ms_kernel

    # phase 1: setup
    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(json.dumps(dict(
        python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)))
    t0 = time.perf_counter()
    ms_kernel.load()
    log("build", json.dumps(dict(kernel="matern_score",
                                 seconds=time.perf_counter() - t0,
                                 nvcc_seconds=ms_kernel.build_seconds)))
    log(ms_kernel.build_log.strip())

    # phase 2: kernel against plain (launches here are not counted)
    rows = kernel_phase(kernels.matern_score, kernels.matern_score_ref)

    # phases 3 and 4: the main path through both entry points
    seq_counts = sequential_phase(core, kernels)
    bat_counts, _, _ = batched_phase(core, kernels)
    for name in kernels.WRAPPERS:
        if seq_counts[name] == 0 or bat_counts[name] == 0:
            raise AssertionError(f"{name} was not launched on the main path "
                                 f"(sequential {seq_counts[name]}, batched "
                                 f"{bat_counts[name]})")
    breakdown_phase(core)

    main_row = next(r for r in rows
                    if (r["S"], r["N"], r["n"], r["d"]) == MAIN_SHAPE)
    log(json.dumps({"kernels": [dict(
        name="matern_score", route="cuda",
        source="src/repro_torch/kernels/matern_score/matern_score.cu",
        replaces="src/repro/kernels/matern_score/kernel.py:38",
        launches=seq_counts["matern_score"] + bat_counts["matern_score"],
        launches_by_path=dict(sequential=seq_counts["matern_score"],
                              batched=bat_counts["matern_score"]),
        max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=None, shape=list(MAIN_SHAPE))]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
