"""Table 1 on the PyTorch port: the nine methods on the split-inference
task (VGG19 / ImageNet-Mini / 5 J / 5 s), as ``benchmarks/table1.py``
runs them on the reference. ``--batched`` routes the BO rows through the
port's batched engine; ``--device`` picks where the BO rows and PPO run
(the card by default; ``--device cpu`` on a machine without one).

    PYTHONPATH=src python -m benchmarks.table1_torch [--batched] [--device cpu]

Writes ``benchmarks/artifacts/table1_torch.json`` (the rows, with the
card's name and power limit on a CUDA run), never the reference's
``table1.json``. Imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import subprocess

import torch

from benchmarks.common import Timer, save_json
from repro_torch.baselines import (CMAES, ComputeFirst, DirectSearch,
                                   ExhaustiveSearch, PPOBaseline,
                                   RandomSearch, TransmitFirst)
from repro_torch.core import (BasicBO, BatchedBayesSplitEdge, BayesSplitEdge,
                              Scenario, default_vgg19_problem)
from repro_torch.core.bo import BASIC_BO_KW
from repro_torch.core.engine_config import EngineConfig
from repro_torch.device import resolve_device

BO_ROWS = ("Bayes-Split-Edge (Ours)", "Basic-BO")
PPO_ROW = "RL (PPO)"
# rows with at most this many evaluations keep their per-evaluation
# answers in full; longer ones (Exhaustive) keep a digest of them
FULL_TRACE_EVALS = 300


class _BatchedRunner:
    """Adapter: runs one scenario through the batched engine."""

    def __init__(self, problem, budget=20, device="cuda", **engine_kw):
        self.problem = problem
        self.budget = budget
        self.device = device
        self.engine_kw = engine_kw

    def run(self, seed=0):
        sc = Scenario(self.problem, seed=seed, budget=self.budget)
        return BatchedBayesSplitEdge([sc], device=self.device,
                                     **self.engine_kw).run()[0]


PAPER_ROWS = {
    "Bayes-Split-Edge (Ours)": (20, 7, 0.38, 87.50, 1.53, 5.00),
    "Basic-BO": (48, 7, 0.40, 85.94, 1.53, 5.00),
    "Exhaustive Search": (36036, 7, 0.37, 87.50, 1.53, 5.00),
    "Direct Search": (80, 7, 0.38, 87.50, 1.53, 5.00),
    "CMA-ES": (32, 2, 0.10, 84.38, 0.11, 3.75),
    "Random Search": (300, 3, 0.28, 84.38, 0.61, 4.01),
    "RL (PPO)": (100, 5, 0.17, 84.38, 1.02, 4.39),
    "Transmit-First": (1, 1, 0.50, 84.38, 0.14, 3.31),
    "Compute-First": (1, 7, 0.34, 84.38, 1.53, 5.00),
}


def algorithms(batched: bool = False, device="cuda", ppo_draws=None):
    """``(name, make(problem) -> runner)`` for the nine rows, in the
    table's order; ``ppo_draws`` (``PPOBaseline.run``'s ``draws``)
    replaces PPO's own."""
    if batched:
        mk_ours = lambda pb: _BatchedRunner(  # noqa: E731
            pb, budget=20, device=device)
        mk_basic = lambda pb: _BatchedRunner(  # noqa: E731
            pb, budget=48, device=device,
            config=EngineConfig(**BASIC_BO_KW))
    else:
        mk_ours = lambda pb: BayesSplitEdge(  # noqa: E731
            pb, budget=20, device=device)
        mk_basic = lambda pb: BasicBO(pb, budget=48,  # noqa: E731
                                      device=device)

    class _PPO(PPOBaseline):
        def run(self, seed=0):
            return super().run(seed, draws=ppo_draws)

    return [
        ("Bayes-Split-Edge (Ours)", mk_ours),
        ("Basic-BO", mk_basic),
        ("Exhaustive Search", lambda pb: ExhaustiveSearch(pb, n_power=1001)),
        ("Direct Search", lambda pb: DirectSearch(pb)),
        ("CMA-ES", lambda pb: CMAES(pb)),
        ("Random Search", lambda pb: RandomSearch(pb)),
        (PPO_ROW, lambda pb: _PPO(pb, device=device)),
        ("Transmit-First", lambda pb: TransmitFirst(pb)),
        ("Compute-First", lambda pb: ComputeFirst(pb)),
    ]


def answers(name, pb, res) -> dict:
    """One row's answers, the same for either package's problem and
    ``BOResult``: the eval count, the best split, power, accuracy and
    utility, feasibility and the incumbent trace; per evaluation the
    accuracy and feasibility bit, and, where the method records its
    evaluations in the problem's ledger, the split layer and power —
    in full up to ``FULL_TRACE_EVALS`` evaluations, else as a digest."""
    feasible = res.best_a is not None
    l, p = pb.denormalize(res.best_a) if feasible else (-1, math.nan)
    per_eval = dict(eval_accuracies=[float(a) for a in res.accuracies],
                    eval_feasible=[bool(f) for f in res.feasible])
    if len(pb.history) == res.n_evals:
        per_eval.update(eval_layers=[int(h.l) for h in pb.history],
                        eval_powers_w=[float(h.p_w) for h in pb.history])
    out = dict(algorithm=name, n_evals=int(res.n_evals),
               split_layer=int(l), power_w=None if not feasible else float(p),
               best_accuracy=float(res.best_accuracy), feasible=feasible,
               best_utility=float(res.best_utility),
               n_feasible_evals=int(sum(per_eval["eval_feasible"])))
    if res.n_evals <= FULL_TRACE_EVALS:
        out.update(per_eval,
                   incumbent_trace=[float(x) for x in res.incumbent_trace])
    else:
        blob = json.dumps({k: per_eval[k] for k in ("eval_accuracies",
                                                    "eval_feasible")})
        out["per_eval_sha256"] = hashlib.sha256(blob.encode()).hexdigest()
    return out


# how a port row is held to the reference's (``mismatches``):
# the host rows exactly (the best utility and the incumbent trace, sums
# of host transcendentals, within HOST_UTILITY_TOL); the BO rows at
# parity level 3 (eval count, split, quantized accuracy and feasibility
# equal, incumbent trace within one 1/64 accuracy quantum); PPO, run on
# the reference's draws, with every evaluation's split layer and
# feasibility bit and the best accuracy equal and every power within
# PPO_POWER_TOL (the CPU run differs by at most 5.96e-8 W, one float32
# step of the action, on seeds 0-2)
QUANTUM = 100.0 / 64.0
HOST_UTILITY_TOL = 1e-9
PPO_POWER_TOL = 1e-6


def mismatches(got: dict, want: dict) -> list:
    """The keys of a row's ``answers`` where ``got`` is not held to
    ``want`` by the row's rule (empty: the row agrees)."""
    name = want["algorithm"]

    def close(a, b, tol):
        if a is None or b is None:
            return a is b
        a, b = (a, b) if isinstance(a, list) else ([a], [b])
        return len(a) == len(b) and all(x == y or abs(x - y) <= tol
                                        for x, y in zip(a, b))

    if name in BO_ROWS:
        exact = ("n_evals", "split_layer", "best_accuracy", "feasible")
        near = dict(incumbent_trace=QUANTUM)
    elif name == PPO_ROW:
        exact = ("n_evals", "split_layer", "best_accuracy", "feasible",
                 "eval_layers", "eval_feasible")
        near = dict(power_w=PPO_POWER_TOL, eval_powers_w=PPO_POWER_TOL)
    else:
        near = dict(best_utility=HOST_UTILITY_TOL,
                    incumbent_trace=HOST_UTILITY_TOL)
        exact = tuple(k for k in want if k not in near)
    bad = [k for k in exact if got.get(k) != want.get(k)]
    bad += [k for k, tol in near.items()
            if k in want and not close(got.get(k), want[k], tol)]
    return sorted(bad)


def table(seed: int = 0, batched: bool = False, device="cuda",
          ppo_draws=None, rows=None):
    """Run the rows (all nine, or the names in ``rows``); returns
    ``[(name, problem, BOResult, wall seconds)]`` in the table's order."""
    out = []
    for name, mk in algorithms(batched, device, ppo_draws):
        if rows is not None and name not in rows:
            continue
        pb = default_vgg19_problem()
        with Timer() as tm:
            res = mk(pb).run(seed=seed)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        out.append((name, pb, res, tm.s))
    return out


def card() -> dict:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    return dict(nvidia_smi=line, name=torch.cuda.get_device_name(0))


def run(seed: int = 0, batched: bool = False, device="cuda"):
    dev = resolve_device(device)
    rows = []
    for name, pb, res, wall in table(seed, batched, dev):
        if res.best_a is None:
            l, p, e, t = -1, float("nan"), float("nan"), float("nan")
        else:
            l, p = pb.denormalize(res.best_a)
            e, t = pb.constraint_values(res.best_a)
        paper = PAPER_ROWS.get(name)
        rows.append(dict(
            algorithm=name, evals=res.n_evals, split_layer=l,
            power_w=round(float(p), 3), accuracy=res.best_accuracy,
            energy_j=round(float(e), 3), delay_s=round(float(t), 3),
            wall_s=wall,
            paper=dict(zip(("evals", "layer", "power", "acc", "E", "tau"),
                           paper)) if paper else None))
    save_json("table1_torch.json", dict(
        device=str(dev), batched=batched, seed=seed,
        card=card() if dev.type == "cuda" else None, rows=rows))
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batched", action="store_true",
                    help="route the BO rows through the batched engine")
    ap.add_argument("--device", default="cuda",
                    help="where the BO rows and PPO run (default: cuda)")
    args, _ = ap.parse_known_args()
    rows = run(batched=args.batched, device=args.device)
    hdr = (f"{'algorithm':26s} {'evals':>6s} {'l':>3s} {'P(W)':>6s} "
           f"{'acc%':>6s} {'E(J)':>6s} {'tau(s)':>6s} {'wall(s)':>8s} "
           f"| paper: l P acc")
    print(hdr)
    for r in rows:
        pp = r["paper"]
        ps = (f"{pp['layer']:>2d} {pp['power']:.2f} {pp['acc']:.2f}"
              if pp else "")
        print(f"{r['algorithm']:26s} {r['evals']:6d} {r['split_layer']:3d} "
              f"{r['power_w']:6.3f} {r['accuracy']:6.2f} {r['energy_j']:6.2f} "
              f"{r['delay_s']:6.2f} {r['wall_s']:8.3f} | {ps}")
    return rows


if __name__ == "__main__":
    main()
