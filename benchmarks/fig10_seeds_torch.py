"""Fig 10 on the PyTorch port: the evaluation at which Bayes-Split-Edge
first reaches 87.5 %, across random seeds (paper: all below 20, mean
below 8), as ``benchmarks/fig10_seeds.py`` computes it on the
reference. ``--batched`` runs all seeds as one run of the port's batched
engine; ``--device`` picks where the BO runs (the card by default;
``--device cpu`` on a machine without one).

    PYTHONPATH=src python -m benchmarks.fig10_seeds_torch \\
        [--batched] [--seeds N] [--device cpu]

Writes ``benchmarks/artifacts/fig10_seeds_torch.json`` (with the card's
name and power limit on a CUDA run). Imports neither ``jax`` nor
``repro``.
"""
from __future__ import annotations

import argparse

import numpy as np

from benchmarks import table1_torch as t1
from benchmarks.common import save_json
from repro_torch.core import (BatchedBayesSplitEdge, BayesSplitEdge, Scenario,
                              default_vgg19_problem)
from repro_torch.device import resolve_device


# every hit and final equal (``mismatches``): the port's runs give the
# reference's accuracy at every step in both modes (measured on the CPU)
TOL = {}


def runs(n_seeds: int = 10, batched: bool = False, device="cuda") -> list:
    """A ``BOResult`` a seed (budget 20)."""
    if batched:
        scs = [Scenario(default_vgg19_problem(), seed=s, budget=20)
               for s in range(n_seeds)]
        return BatchedBayesSplitEdge(scs, device=device).run()
    return [BayesSplitEdge(default_vgg19_problem(), budget=20,
                           device=device).run(seed=seed)
            for seed in range(n_seeds)]


def figure(results: list) -> list:
    """Each seed's first evaluation at 87.5 % (None: never)."""
    return [next((i + 1 for i, a in enumerate(res.accuracies) if a >= 87.5),
                 None) for res in results]


def answers(out, finals: list) -> dict:
    """The figure's numbers and every BO run's final (split layer,
    quantized accuracy, feasibility, evaluations) in the order the runs
    finished (``table1_torch.finals_recorded`` around ``run``)."""
    return t1.normalized(dict(hits=out, finals=finals))


def mismatches(got: dict, want: dict) -> list:
    """The paths of ``answers`` not held to the reference's by ``TOL``
    (every other number equal)."""
    return t1.differences(got, want, TOL)


def run(n_seeds: int = 10, batched: bool = False, device="cuda") -> list:
    dev = resolve_device(device)
    hits = figure(runs(n_seeds, batched, dev))
    save_json("fig10_seeds_torch.json", dict(
        hits=hits, batched=batched, device=str(dev),
        card=t1.card() if dev.type == "cuda" else None))
    return hits


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batched", action="store_true",
                    help="run all seeds as one batched BO run")
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="where the BO runs (default: cuda)")
    args, _ = ap.parse_known_args(argv)
    hits = run(args.seeds, batched=args.batched, device=args.device)
    ok = [h for h in hits if h is not None]
    print(f"converged {len(ok)}/{len(hits)} seeds; iterations: {hits}")
    if ok:
        print(f"mean convergence iteration: {np.mean(ok):.1f} "
              f"(paper: < 8, all < 20)")
    return hits


if __name__ == "__main__":
    main()
