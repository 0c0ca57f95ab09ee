"""Single-resource greedy heuristics (§6.2). Both pick their configuration
from the *analytic* constraint models (1 oracle evaluation each).
The port's copy of ``repro/baselines/greedy.py`` (host numpy)."""
from __future__ import annotations

import numpy as np

from repro_torch.core.bo import BOResult


def _result(pb, l, p):
    a = pb.normalize(l, p)
    u = pb.evaluate(a)
    rec = pb.history[-1]
    return BOResult(a, u, rec.accuracy, 1, [u], [rec.accuracy],
                    [rec.feasible], [u])


class TransmitFirst:
    """Prioritizes transmission: shallowest feasible split at P_max
    (minimum local compute), decrementing power if none is feasible."""
    name = "Transmit-First"

    def __init__(self, problem):
        self.problem = problem

    def run(self, seed: int = 0) -> BOResult:
        pb = self.problem
        for p in np.linspace(pb.p_max, pb.p_min + 1e-6, 10):
            for l in range(1, pb.L + 1):
                if pb.feasible(pb.normalize(l, float(p))):
                    return _result(pb, l, float(p))
        return _result(pb, 1, pb.p_max)


class ComputeFirst:
    """Fixes the deepest split layer with a nonempty feasible power set and
    takes its maximum feasible transmit power, backing off layers if
    infeasible."""
    name = "Compute-First"

    def __init__(self, problem, n_power: int = 101):
        self.problem = problem
        self.n_power = n_power

    def run(self, seed: int = 0) -> BOResult:
        pb = self.problem
        for l in range(pb.L, 0, -1):
            ps = np.linspace(pb.p_max, pb.p_min, self.n_power)
            for p in ps:                      # max feasible power first
                if pb.feasible(pb.normalize(l, float(p))):
                    return _result(pb, l, float(p))
        return _result(pb, pb.L, pb.p_max)
