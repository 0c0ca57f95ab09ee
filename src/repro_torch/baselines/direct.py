"""DIRECT (DIviding RECTangles; Jones et al. 1993) — gradient-free baseline.

Maximizes utility (internally minimizes -U). Potentially-optimal
rectangles selected via the lower convex hull over (diameter, f) with the
epsilon-improvement condition. Cap 100 evals, early stop after 20
non-improving trials (§6.2).
The port's copy of ``repro/baselines/direct.py`` (host numpy).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.core.bo import BOResult


@dataclasses.dataclass
class _Rect:
    center: np.ndarray
    levels: np.ndarray           # per-dim trisection count
    f: float

    @property
    def diameter(self) -> float:
        sides = 3.0 ** (-self.levels.astype(float))
        return 0.5 * float(np.linalg.norm(sides))


class DirectSearch:
    name = "Direct Search"

    def __init__(self, problem, budget: int = 100, patience: int = 20,
                 eps: float = 1e-4):
        self.problem = problem
        self.budget = budget
        self.patience = patience
        self.eps = eps

    def run(self, seed: int = 0) -> BOResult:
        pb = self.problem
        utilities, accs, feas, inc = [], [], [], []
        best_a, best_u, best_acc = None, -np.inf, 0.0
        stale = 0

        def evaluate(a):
            nonlocal best_a, best_u, best_acc, stale
            u = pb.evaluate(a)
            rec = pb.history[-1]
            utilities.append(u)
            accs.append(rec.accuracy)
            feas.append(rec.feasible)
            if rec.feasible and u > best_u:
                best_a, best_u, best_acc = np.asarray(a), u, rec.accuracy
                stale = 0
            else:
                stale += 1
            inc.append(best_u if np.isfinite(best_u) else 0.0)
            return -u  # minimize

        c0 = np.array([0.5, 0.5])
        rects: List[_Rect] = [_Rect(c0, np.zeros(2, int), evaluate(c0))]

        while len(utilities) < self.budget and stale < self.patience:
            sel = self._potentially_optimal(rects)
            if not sel:
                sel = [int(np.argmin([r.f for r in rects]))]
            progressed = False
            for idx in sorted(sel, reverse=True):
                if len(utilities) >= self.budget:
                    break
                r = rects.pop(idx)
                dim = int(np.argmin(r.levels))      # longest side
                step = 3.0 ** (-(r.levels[dim] + 1))
                for delta in (-step, step):
                    if len(utilities) >= self.budget:
                        break
                    c = r.center.copy()
                    c[dim] = np.clip(c[dim] + delta, 0, 1)
                    lv = r.levels.copy()
                    lv[dim] += 1
                    rects.append(_Rect(c, lv, evaluate(c)))
                r.levels[dim] += 1                   # center keeps its f
                rects.append(r)
                progressed = True
            if not progressed:
                break

        return BOResult(best_a, float(best_u), float(best_acc),
                        len(utilities), utilities, accs, feas, inc)

    def _potentially_optimal(self, rects: List[_Rect]) -> List[int]:
        fmin = min(r.f for r in rects)
        # best rect per diameter bucket
        byd = {}
        for i, r in enumerate(rects):
            d = round(r.diameter, 12)
            if d not in byd or rects[byd[d]].f > r.f:
                byd[d] = i
        ds = sorted(byd)
        idxs = [byd[d] for d in ds]
        # lower-right convex hull over (d, f), largest d always kept
        hull: List[int] = []
        for i in idxs:
            while len(hull) >= 2:
                i1, i2 = hull[-2], hull[-1]
                d1, f1 = rects[i1].diameter, rects[i1].f
                d2, f2 = rects[i2].diameter, rects[i2].f
                d3, f3 = rects[i].diameter, rects[i].f
                if (f2 - f1) * (d3 - d1) >= (f3 - f1) * (d2 - d1):
                    hull.pop()
                else:
                    break
            hull.append(i)
        # epsilon condition vs fmin
        out = []
        for j, i in enumerate(hull):
            r = rects[i]
            if j + 1 < len(hull):
                nxt = rects[hull[j + 1]]
                slope = (nxt.f - r.f) / max(nxt.diameter - r.diameter, 1e-12)
                bound = r.f - slope * r.diameter
            else:
                bound = r.f
            if bound <= fmin - self.eps * abs(fmin) or j + 1 == len(hull):
                out.append(i)
        return out
