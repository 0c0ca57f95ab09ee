"""Benchmark harness of the PyTorch port: one entry a paper table or
figure, as ``benchmarks/run.py`` runs the reference's.

    PYTHONPATH=src python -m benchmarks.run_torch [names...] [--device cpu]

Prints one CSV line a benchmark: name, seconds, derived headline.
``--device`` is passed to every script (the card by default). It has no
``roofline`` entry: ``benchmarks/roofline_report.py`` reads the
reference's TPU dry-run artifacts, from which no H100 number comes, and
has no counterpart in the port. Imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from benchmarks import (fig6_convergence_torch, fig7_space_torch,
                        fig8_regret_torch, fig9_ablation_torch,
                        fig10_seeds_torch, profiling_torch, table1_torch,
                        trace_robustness_torch)
from repro_torch.device import resolve_device


def _derived_table1(rows):
    ours = next(r for r in rows if "Ours" in r["algorithm"])
    exh = next(r for r in rows if "Exhaustive" in r["algorithm"])
    return (f"ours: l={ours['split_layer']} P={ours['power_w']} "
            f"acc={ours['accuracy']} in {ours['evals']} evals "
            f"({exh['evals'] // max(ours['evals'], 1)}x fewer than exhaustive)")


def _derived_fig10(hits):
    ok = [h for h in hits if h]
    return (f"{len(ok)}/{len(hits)} seeds converged, "
            f"mean iter {np.mean(ok):.1f}" if ok else "no convergence")


BENCHES = [
    ("table1", table1_torch.main, _derived_table1),
    ("fig2-4_profiling", profiling_torch.main,
     lambda o: f"{len(o['layers'])} layers profiled"),
    ("fig6_convergence", fig6_convergence_torch.main,
     lambda o: f"{len(o)} strategies traced"),
    ("fig7_space", fig7_space_torch.main,
     lambda o: f"band={len(o['optimum_band'])} pts"),
    ("fig8_regret", fig8_regret_torch.main,
     lambda o: "; ".join(
         f"{p}: ours {c['Bayes-Split-Edge']['decay_exponent']:.2f} vs "
         f"basic {c['Basic-BO']['decay_exponent']:.2f}"
         for p, c in o.items())),
    ("fig9_ablation", fig9_ablation_torch.main,
     lambda o: f"{len(o)} variants"),
    ("fig10_seeds", fig10_seeds_torch.main, _derived_fig10),
    ("trace_robustness", trace_robustness_torch.main,
     lambda rows: f"{sum(1 for r in rows if r.get('feasible'))}/"
                  f"{len(rows)} frames solved"),
]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*",
                    help=f"benchmarks to run (default: all of "
                         f"{[name for name, _, _ in BENCHES]})")
    ap.add_argument("--device", default="cuda",
                    help="passed to every benchmark (default: cuda)")
    args = ap.parse_args(argv)
    resolve_device(args.device)         # no CUDA device: raise here, once
    print("benchmark,seconds,derived")
    for name, fn, derived in BENCHES:
        if args.names and name not in args.names:
            continue
        print(f"\n===== {name} =====", flush=True)
        t0 = time.time()
        try:
            d = derived(fn(["--device", args.device]))
        except Exception as e:  # noqa: BLE001
            d = f"ERROR {type(e).__name__}: {e}"
        print(f"CSV,{name},{time.time() - t0:.1f},{d}", flush=True)


if __name__ == "__main__":
    main()
