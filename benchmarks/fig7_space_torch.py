"""Fig 7 on the PyTorch port: the split-layer x transmit-power search
space, its feasible region, the exhaustive optimum band, and where each
method sampled, as ``benchmarks/fig7_space.py`` computes them on the
reference (seed 0). ``--device`` picks where the BO methods and PPO run
(the card by default; ``--device cpu`` on a machine without one).

    PYTHONPATH=src python -m benchmarks.fig7_space_torch [--device cpu]

The 37 x 51 feasibility grid and the optimum band are host code; the
samples are each method's ``problem.history``. ``runs`` makes the runs
and ``figure`` turns ``{name: (problem, BOResult)}`` into the figure's
numbers; Bayes-Split-Edge, Basic-BO, Direct Search and PPO are Table 1's
very calls, so ``runs`` takes them from a sequential
``table1_torch.table`` where one is given. Writes
``benchmarks/artifacts/fig7_space_torch.json`` (with the card's name and
power limit on a CUDA run). Imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import argparse

import numpy as np

from benchmarks import table1_torch as t1
from benchmarks.common import save_json
from benchmarks.fig6_convergence_torch import CARD_LEVEL3
from repro_torch.baselines import (CMAES, DirectSearch, ExhaustiveSearch,
                                   RandomSearch)
from repro_torch.core import default_vgg19_problem
from repro_torch.device import resolve_device

# how the port's answers are held to the reference's (``mismatches``):
# the grid, the band, the host methods' samples and every sample's split
# layer and feasibility bit equal; the power of a BO method's sample
# within BO_POWER_TOL, PPO's (on the reference's draws) within
# table1_torch.PPO_POWER_TOL. Measured on the CPU: Bayes-Split-Edge's
# powers lie 7.5e-8 W from the reference's, PPO's 6.0e-8 W. Basic-BO's
# refined candidate differs in its last float32 bits from sample 11 on
# (4.2e-7 W), which moves the next acquisitions' optima: its powers lay
# up to 4.2e-5 W off on one CPU and 1.24e-3 W on another (an AMD EPYC),
# every split layer and feasibility bit equal. So on the CPU as on the
# card (``on_card``) Basic-BO is held at parity level 3 (``level3``):
# each sample's split layer and feasibility bit equal, its power not
# held; its incumbent trace is held within one quantum by Fig 6.
BO_POWER_TOL = 1e-4
CPU_LEVEL3 = ("Basic-BO",)
TOL = {r"^/samples/(Bayes-Split-Edge|Basic-BO)/\*/p$": BO_POWER_TOL,
       r"^/samples/RL \(PPO\)/\*/p$": t1.PPO_POWER_TOL}


def algorithms(device="cuda", ppo_draws=None):
    """``(name, make(problem))`` in the figure's order."""
    return [("Bayes-Split-Edge", t1.bayes_split_edge(device)),
            ("Basic-BO", t1.basic_bo(device)),
            ("Direct Search", lambda pb: DirectSearch(pb)),
            ("CMA-ES", lambda pb: CMAES(pb, budget=32)),
            ("Random Search", lambda pb: RandomSearch(pb, budget=48)),
            (t1.PPO_ROW, t1.ppo(device, ppo_draws))]


def runs(seed: int = 0, device="cuda", ppo_draws=None, table1=None) -> dict:
    """``{name: (problem, BOResult)}``; ``table1`` as in
    ``table1_torch.figure_runs``."""
    return t1.figure_runs(algorithms(device, ppo_draws), seed, device, table1)


def space() -> tuple:
    """The feasibility grid (37 layers x 51 powers) and the optimum band
    (``ExhaustiveSearch(n_power=201).optimal_band(tol=2e-2)``, the
    paper's "0.35-0.39 W" at layer 7)."""
    pb = default_vgg19_problem()
    grid = []
    for l in range(1, pb.L + 1):
        for p in np.linspace(pb.p_min, pb.p_max, 51):
            a = pb.normalize(l, float(p))
            _, acc = pb._accuracy(l, float(p))
            grid.append(dict(l=l, p=float(p), feasible=bool(pb.feasible(a)),
                             acc=float(acc)))
    band = ExhaustiveSearch(pb, n_power=201).optimal_band(tol=2e-2)
    return grid, [(int(l), float(p)) for l, p in band]


def figure(runs_: dict) -> dict:
    """The grid, the band and each method's samples (split layer, power,
    feasibility bit of every evaluation in its ledger)."""
    grid, band = space()
    samples = {name: [dict(l=int(r.l), p=float(r.p_w),
                           feasible=bool(r.feasible)) for r in pb.history]
               for name, (pb, _) in runs_.items()}
    return dict(grid=grid, optimum_band=band, samples=samples)


def answers(out: dict) -> dict:
    return t1.normalized(out)


def mismatches(got: dict, want: dict, on_card: bool = False,
               level3: tuple = ()) -> list:
    """The paths of ``answers`` not held to the reference's by ``TOL``
    (every other number equal). ``on_card``: of the methods in
    ``fig6_convergence_torch.CARD_LEVEL3``, which leave the reference's
    path on the card, only the number of samples is held (their runs are
    held at parity level 3 by Fig 6 and Table 1). ``level3``: of these
    methods each sample's split layer and feasibility bit are held, not
    its power (``CPU_LEVEL3``)."""
    if on_card:
        got, want = (dict(a, samples={
            name: len(v) if name in CARD_LEVEL3 else v
            for name, v in a["samples"].items()}) for a in (got, want))
    if level3:
        got, want = (dict(a, samples={
            name: ([dict(l=x["l"], feasible=x["feasible"]) for x in v]
                   if name in level3 and isinstance(v, list) else v)
            for name, v in a["samples"].items()}) for a in (got, want))
    return t1.differences(got, want, TOL)


def run(seed: int = 0, device="cuda", ppo_draws=None, table1=None) -> dict:
    dev = resolve_device(device)
    out = figure(runs(seed, dev, ppo_draws, table1))
    save_json("fig7_space_torch.json", dict(
        out, device=str(dev), seed=seed,
        card=t1.card() if dev.type == "cuda" else None))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the BO methods and PPO run (default: cuda)")
    args, _ = ap.parse_known_args(argv)
    out = run(device=args.device)
    band = out["optimum_band"]
    ls = sorted(set(l for l, _ in band))
    ps = [p for _, p in band]
    print(f"optimum band: layers {ls}, P in [{min(ps):.3f}, {max(ps):.3f}] W "
          f"(paper: layer 7, 0.35-0.39 W)")
    for name, s in out["samples"].items():
        inside = sum(1 for x in s if x["feasible"])
        print(f"{name:18s}: {len(s):3d} samples, {inside:3d} feasible "
              f"({100*inside/len(s):.0f}%)")
    return out


if __name__ == "__main__":
    main()
