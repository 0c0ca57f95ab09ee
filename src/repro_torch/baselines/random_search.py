"""Uniform random search, 300 samples (§6.2).
The port's copy of ``repro/baselines/random_search.py`` (host numpy)."""
from __future__ import annotations

import numpy as np

from repro_torch.core.bo import BOResult


class RandomSearch:
    name = "Random Search"

    def __init__(self, problem, budget: int = 300):
        self.problem = problem
        self.budget = budget

    def run(self, seed: int = 0) -> BOResult:
        pb = self.problem
        rng = np.random.default_rng(seed)
        best_a, best_u, best_acc = None, -np.inf, 0.0
        utilities, accs, feas, inc = [], [], [], []
        for _ in range(self.budget):
            a = rng.random(2)
            u = pb.evaluate(a)
            rec = pb.history[-1]
            utilities.append(u)
            accs.append(rec.accuracy)
            feas.append(rec.feasible)
            if rec.feasible and u > best_u:
                best_a, best_u, best_acc = a, u, rec.accuracy
            inc.append(best_u if np.isfinite(best_u) else 0.0)
        return BOResult(best_a, float(best_u), float(best_acc),
                        len(utilities), utilities, accs, feas, inc)
