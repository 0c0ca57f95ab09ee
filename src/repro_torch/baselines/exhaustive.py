"""Exhaustive search over L x |P| configurations (§6.2). Offline
ground-truth benchmark: O(L * |P|) evaluations.
The port's copy of ``repro/baselines/exhaustive.py`` (host numpy)."""
from __future__ import annotations

import numpy as np

from repro_torch.core.bo import BOResult


class ExhaustiveSearch:
    name = "Exhaustive Search"

    def __init__(self, problem, n_power: int = 1001):
        self.problem = problem
        self.n_power = n_power

    def run(self, seed: int = 0) -> BOResult:
        pb = self.problem
        best_a, best_u, best_acc = None, -np.inf, 0.0
        n = 0
        utilities, accs, feas = [], [], []
        for l in range(1, pb.L + 1):
            for pn in np.linspace(0, 1, self.n_power):
                a = np.array([pn, (l - 1) / (pb.L - 1)])
                u = pb.evaluate(a, record=False)
                n += 1
                utilities.append(u)
                ok = pb.feasible(a)
                feas.append(ok)
                _, acc = pb._accuracy(*pb.denormalize(a))
                accs.append(acc)
                if ok and u > best_u:
                    best_a, best_u, best_acc = a, u, acc
        inc = np.maximum.accumulate(np.where(feas, utilities, -np.inf))
        return BOResult(best_a, float(best_u), float(best_acc), n,
                        utilities, accs, feas, inc.tolist())

    def optimal_band(self, tol: float = 5e-3):
        """All (l, P) whose utility is within `tol` of the optimum —
        reproduces the paper's 'P in 0.35-0.39' band."""
        pb = self.problem
        _, u_star = pb.exhaustive_optimum(self.n_power)
        band = []
        for l in range(1, pb.L + 1):
            for pn in np.linspace(0, 1, self.n_power):
                a = np.array([pn, (l - 1) / (pb.L - 1)])
                lu, p = pb.denormalize(a)
                u, _ = pb._accuracy(lu, p)
                if u >= u_star - tol:
                    band.append((lu, p))
        return band
