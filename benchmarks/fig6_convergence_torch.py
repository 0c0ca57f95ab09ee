"""Fig 6 on the PyTorch port: accuracy per evaluation step for six
split-inference strategies under the 5 J / 5 s budget, as
``benchmarks/fig6_convergence.py`` runs them on the reference (seed 0).
``--device`` picks where the BO methods and PPO run (the card by
default; ``--device cpu`` on a machine without one).

    PYTHONPATH=src python -m benchmarks.fig6_convergence_torch [--device cpu]

``runs`` makes the runs and ``figure`` turns ``{name: (problem,
BOResult)}`` into the figure's numbers; Bayes-Split-Edge, Basic-BO,
Direct Search and PPO are Table 1's very calls, so ``runs`` takes them
from a sequential ``table1_torch.table`` where one is given. Writes
``benchmarks/artifacts/fig6_convergence_torch.json`` (with the card's
name and power limit on a CUDA run). Imports neither ``jax`` nor
``repro``.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from benchmarks import table1_torch as t1
from benchmarks.common import save_json
from repro_torch.baselines import CMAES, DirectSearch, RandomSearch
from repro_torch.device import resolve_device

# On the card Basic-BO (constraint-agnostic, its GP trained on every
# evaluation, the infeasible zeros included) leaves the reference's path
# of evaluations: the float32 library calls of its fits give other last
# bits there, and its posterior turns them into other picks (H100 run:
# per-step accuracies up to 84.375 apart, a feasible step against an
# infeasible one; Table 1's row of the same run holds at parity level
# 3). There its steps are held at that level: the step count and the
# final best accuracy equal, the best feasible accuracy so far within
# one accuracy quantum at every step. Bayes-Split-Edge held every step.
CARD_LEVEL3 = ("Basic-BO",)


def algorithms(device="cuda", ppo_draws=None):
    """``(name, make(problem))`` in the figure's order."""
    return [("Bayes-Split-Edge", t1.bayes_split_edge(device)),
            ("Basic-BO", t1.basic_bo(device)),
            ("Direct Search", lambda pb: DirectSearch(pb)),
            ("CMA-ES", lambda pb: CMAES(pb, budget=48)),
            ("Random Search", lambda pb: RandomSearch(pb, budget=48)),
            (t1.PPO_ROW, t1.ppo(device, ppo_draws))]


def runs(seed: int = 0, device="cuda", ppo_draws=None, table1=None) -> dict:
    """``{name: (problem, BOResult)}``; ``table1`` as in
    ``table1_torch.figure_runs``."""
    return t1.figure_runs(algorithms(device, ppo_draws), seed, device, table1)


def figure(runs_: dict) -> dict:
    """Each method's accuracy and feasibility bit per evaluation."""
    return {name: dict(acc_per_step=[float(a) for a in res.accuracies],
                       feasible=[bool(f) for f in res.feasible])
            for name, (_, res) in runs_.items()}


def answers(out: dict) -> dict:
    return t1.normalized(out)


def level3(answers_: dict, names) -> dict:
    """``answers`` with the steps of each method in ``names`` as parity
    level 3 reads a run: its step count, the best feasible accuracy so
    far at every step (0 before the first feasible step) and the last of
    them."""
    out = json.loads(json.dumps(answers_))
    for name in names:
        trace = out[name]
        best, so_far = 0.0, []
        for acc, ok in zip(trace.pop("acc_per_step"), trace.pop("feasible")):
            best = max(best, acc) if ok else best
            so_far.append(best)
        trace.update(steps=len(so_far), best_so_far=so_far, best=best)
    return out


def mismatches(got: dict, want: dict, on_card: bool = False) -> list:
    """The paths of ``answers`` where ``got`` is not held to ``want``.
    Every number equal: the host methods are the reference's code, and
    the BO methods' cold runs and PPO on the reference's draws give the
    reference's quantized accuracy at every step on the CPU. ``on_card``:
    the methods of CARD_LEVEL3 are held at parity level 3 instead."""
    names = CARD_LEVEL3 if on_card else ()
    return t1.differences(level3(got, names), level3(want, names),
                          {r"/best_so_far/": t1.QUANTUM})


def run(seed: int = 0, device="cuda", ppo_draws=None, table1=None) -> dict:
    dev = resolve_device(device)
    out = figure(runs(seed, dev, ppo_draws, table1))
    save_json("fig6_convergence_torch.json", dict(
        device=str(dev), seed=seed,
        card=t1.card() if dev.type == "cuda" else None, traces=out))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the BO methods and PPO run (default: cuda)")
    args, _ = ap.parse_known_args(argv)
    traces = run(device=args.device)
    print(f"{'algorithm':18s} {'steps':>5s} {'min%':>6s} {'max%':>6s} "
          f"{'zero-dips':>9s} {'feas%':>6s}")
    for name, t in traces.items():
        acc = np.array(t["acc_per_step"])
        print(f"{name:18s} {len(acc):5d} {acc.min():6.2f} {acc.max():6.2f} "
              f"{(acc == 0).sum():9d} {100*np.mean(t['feasible']):6.1f}")
    return traces


if __name__ == "__main__":
    main()
