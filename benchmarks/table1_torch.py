"""Table 1 on the PyTorch port: the nine methods on the split-inference
task (VGG19 / ImageNet-Mini / 5 J / 5 s), as ``benchmarks/table1.py``
runs them on the reference. ``--batched`` routes the BO rows through the
port's batched engine; ``--device`` picks where the BO rows and PPO run
(the card by default; ``--device cpu`` on a machine without one).

    PYTHONPATH=src python -m benchmarks.table1_torch [--batched] [--device cpu]

Writes ``benchmarks/artifacts/table1_torch.json`` (the rows, with the
card's name and power limit on a CUDA run), never the reference's
``table1.json``. Imports neither ``jax`` nor ``repro``.

The figure scripts (``benchmarks/*_torch.py``) reuse its method makers
(``bayes_split_edge``, ``basic_bo``, ``ppo``), ``run_method``,
``figure_runs`` (Figs 6 and 7 from a sequential table's runs),
``card``, and the answer helpers ``deviations``/``differences``,
``normalized`` and ``finals_recorded``.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import math
import re
import subprocess
from unittest import mock

import torch

from benchmarks.common import Timer, _np_default, save_json
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


def bayes_split_edge(device="cuda", batched=False, budget=20):
    """``make(problem)`` for Bayes-Split-Edge: ``BayesSplitEdge``, or one
    scenario through the batched engine."""
    if batched:
        return lambda pb: _BatchedRunner(pb, budget=budget, device=device)
    return lambda pb: BayesSplitEdge(pb, budget=budget, device=device)


def basic_bo(device="cuda", batched=False, budget=48):
    """``make(problem)`` for Basic-BO (``BASIC_BO_KW``), sequential or
    through the batched engine."""
    if batched:
        return lambda pb: _BatchedRunner(pb, budget=budget, device=device,
                                         config=EngineConfig(**BASIC_BO_KW))
    return lambda pb: BasicBO(pb, budget=budget, device=device)


def ppo(device="cuda", draws=None):
    """``make(problem)`` for PPO; ``draws`` (``PPOBaseline.run``'s)
    replaces its own."""
    class _PPO(PPOBaseline):
        def run(self, seed=0):
            return super().run(seed, draws=draws)

    return lambda pb: _PPO(pb, device=device)


def algorithms(batched: bool = False, device="cuda", ppo_draws=None):
    """``(name, make(problem) -> runner)`` for the nine rows, in the
    table's order; ``ppo_draws`` (``PPOBaseline.run``'s ``draws``)
    replaces PPO's own."""
    return [
        ("Bayes-Split-Edge (Ours)", bayes_split_edge(device, batched)),
        ("Basic-BO", basic_bo(device, batched)),
        ("Exhaustive Search", lambda pb: ExhaustiveSearch(pb, n_power=1001)),
        ("Direct Search", lambda pb: DirectSearch(pb)),
        ("CMA-ES", lambda pb: CMAES(pb)),
        ("Random Search", lambda pb: RandomSearch(pb)),
        (PPO_ROW, ppo(device, ppo_draws)),
        ("Transmit-First", lambda pb: TransmitFirst(pb)),
        ("Compute-First", lambda pb: ComputeFirst(pb)),
    ]


# the rows Figs 6 and 7 run with Table 1's very calls (seed 0, the same
# budgets), by the figures' names: their runs can be taken from a
# sequential Table 1 instead of being run again
FIGURE_NAMES = {"Bayes-Split-Edge (Ours)": "Bayes-Split-Edge",
                "Basic-BO": "Basic-BO", "Direct Search": "Direct Search",
                PPO_ROW: PPO_ROW}


def run_method(make, seed: int = 0, device="cuda"):
    """One method on a fresh ``default_vgg19_problem()``: ``(problem,
    BOResult, wall seconds)``, the card synchronised before the clock
    stops."""
    pb = default_vgg19_problem()
    with Timer() as tm:
        res = make(pb).run(seed=seed)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    return pb, res, tm.s


def figure_runs(algos, seed: int = 0, device="cuda", table1=None) -> dict:
    """``{name: (problem, BOResult)}`` for a figure's ``(name, make)``
    methods. ``table1`` (``table()``'s sequential rows) gives the runs of
    the methods in ``FIGURE_NAMES``, which are then not run again."""
    shared = {FIGURE_NAMES[name]: (pb, res)
              for name, pb, res, _ in (table1 or ()) if name in FIGURE_NAMES}
    return {name: shared.get(name) or run_method(mk, seed, device)[:2]
            for name, mk in algos}


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
    return [(name, *run_method(mk, seed, device))
            for name, mk in algorithms(batched, device, ppo_draws)
            if rows is None or name in rows]


def deviations(got, want, path="") -> dict:
    """Where the JSON-like ``got`` is not ``want``: ``{path: largest
    |got - want|}`` over the numbers that differ (NaN equals NaN), and
    ``inf`` where the structure, a string, a bool or None differs. A path
    is ``key/index/...`` with each list index written ``*``."""
    here = re.sub(r"/\d+(?=/|$)", "/*", path) or "/"
    if isinstance(want, dict) or isinstance(want, (list, tuple)):
        keys = (list(want) if isinstance(want, dict)
                else range(len(want)))
        same = (isinstance(got, dict) and set(got) == set(want)
                if isinstance(want, dict) else
                isinstance(got, (list, tuple)) and len(got) == len(want))
        if not same:
            return {here: math.inf}
        out = {}
        for k in keys:
            for p, d in deviations(got[k], want[k], f"{path}/{k}").items():
                out[p] = max(out.get(p, 0.0), d)
        return out
    number = (int, float)
    if (isinstance(want, bool) or not isinstance(want, number)
            or isinstance(got, bool) or not isinstance(got, number)):
        return {} if type(got) is type(want) and got == want else {
            here: math.inf}
    if got == want or (math.isnan(got) and math.isnan(want)):
        return {}
    return {here: abs(got - want)}


def differences(got, want, tol=None) -> list:
    """The paths of ``deviations`` beyond their tolerance: ``tol`` maps
    a path (a regular expression, searched) to the largest deviation
    allowed there; every other path must be equal."""
    return sorted(p for p, d in deviations(got, want).items()
                  if not d <= next((t for pat, t in (tol or {}).items()
                                    if re.search(pat, p)), 0.0))


@contextlib.contextmanager
def finals_recorded(bo_module):
    """Record the final split layer (-1: none found), quantized accuracy,
    feasibility and evaluation count of every BO run that ``bo_module.ScenarioState``
    finishes in the block, in the order they finish: the sequential and
    the batched engine of either package (``bo_module`` is
    ``repro_torch.core.bo`` or the reference's ``repro.core.bo``). Yields
    the list."""
    seen = []
    result = bo_module.ScenarioState.result

    def recorded(state):
        res = result(state)
        found = res.best_a is not None
        seen.append(dict(
            split_layer=int(state.pb.denormalize(res.best_a)[0]) if found
            else -1, best_accuracy=float(res.best_accuracy), feasible=found,
            n_evals=int(res.n_evals)))
        return res

    with mock.patch.object(bo_module.ScenarioState, "result", recorded):
        yield seen


def normalized(obj):
    """``obj`` as JSON gives it back (tuples as lists, numpy scalars as
    Python numbers): the form the expected files hold."""
    return json.loads(json.dumps(obj, default=_np_default))


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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batched", action="store_true",
                    help="route the BO rows through the batched engine")
    ap.add_argument("--device", default="cuda",
                    help="where the BO rows and PPO run (default: cuda)")
    args, _ = ap.parse_known_args(argv)
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
