"""CMA-ES (Hansen & Ostermeier 2001) — adaptive gradient-free baseline.

Population 10 per generation over normalized (power, layer); samples are
clipped to [0,1]^2, layer rounded at evaluation; infeasible scored 0
accuracy (the oracle already does this). Cap 300 evals, early stop after
20 non-improving samples (§6.2).
The port's copy of ``repro/baselines/cmaes.py`` (host numpy).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.bo import BOResult


class CMAES:
    name = "CMA-ES"

    def __init__(self, problem, budget: int = 300, popsize: int = 10,
                 patience: int = 20, sigma0: float = 0.3):
        self.problem = problem
        self.budget = budget
        self.popsize = popsize
        self.patience = patience
        self.sigma0 = sigma0

    def run(self, seed: int = 0) -> BOResult:
        pb = self.problem
        rng = np.random.default_rng(seed)
        n = 2
        lam = self.popsize
        mu = lam // 2
        w = np.log(mu + 0.5) - np.log(np.arange(1, mu + 1))
        w /= w.sum()
        mueff = 1.0 / np.sum(w ** 2)
        cc = (4 + mueff / n) / (n + 4 + 2 * mueff / n)
        cs = (mueff + 2) / (n + mueff + 5)
        c1 = 2 / ((n + 1.3) ** 2 + mueff)
        cmu = min(1 - c1, 2 * (mueff - 2 + 1 / mueff) / ((n + 2) ** 2 + mueff))
        damps = 1 + 2 * max(0, np.sqrt((mueff - 1) / (n + 1)) - 1) + cs
        chin = np.sqrt(n) * (1 - 1 / (4 * n) + 1 / (21 * n ** 2))

        mean = np.array([0.5, 0.5])
        sigma = self.sigma0
        C = np.eye(n)
        ps, pc = np.zeros(n), np.zeros(n)

        utilities, accs, feas, inc = [], [], [], []
        best_a, best_u, best_acc = None, -np.inf, 0.0
        stale = 0
        g = 0
        while len(utilities) < self.budget and stale < self.patience:
            g += 1
            try:
                A = np.linalg.cholesky(C + 1e-12 * np.eye(n))
            except np.linalg.LinAlgError:
                C = np.eye(n)
                A = np.eye(n)
            zs = rng.standard_normal((lam, n))
            xs = mean + sigma * zs @ A.T
            xs = np.clip(xs, 0, 1)
            fs = []
            for x in xs:
                if len(utilities) >= self.budget:
                    break
                u = pb.evaluate(x)
                rec = pb.history[-1]
                utilities.append(u)
                accs.append(rec.accuracy)
                feas.append(rec.feasible)
                if rec.feasible and u > best_u:
                    best_a, best_u, best_acc = x.copy(), u, rec.accuracy
                    stale = 0
                else:
                    stale += 1
                inc.append(best_u if np.isfinite(best_u) else 0.0)
                fs.append(-u)
            if len(fs) < lam:
                break
            order = np.argsort(fs)[:mu]
            xw = xs[order]
            zw = zs[order]
            mean_new = w @ xw
            zmean = w @ zw
            ps = (1 - cs) * ps + np.sqrt(cs * (2 - cs) * mueff) * (A @ zmean)
            hsig = (np.linalg.norm(ps)
                    / np.sqrt(1 - (1 - cs) ** (2 * g)) / chin) < 1.4 + 2 / (n + 1)
            pc = (1 - cc) * pc + hsig * np.sqrt(cc * (2 - cc) * mueff) \
                * (mean_new - mean) / sigma
            artmp = (xw - mean) / sigma
            C = ((1 - c1 - cmu) * C
                 + c1 * (np.outer(pc, pc) + (not hsig) * cc * (2 - cc) * C)
                 + cmu * artmp.T @ np.diag(w) @ artmp)
            sigma *= np.exp((cs / damps) * (np.linalg.norm(ps) / chin - 1))
            sigma = float(np.clip(sigma, 1e-4, 1.0))
            mean = mean_new

        return BOResult(best_a, float(best_u), float(best_acc),
                        len(utilities), utilities, accs, feas, inc)
