"""Bayes-Split-Edge (Algorithm 1) and Basic-BO. Counterpart of
``repro/core/bo.py``: the host bookkeeping is the same numpy code; the
GP fit and the acquisition run as torch on ``device``.

Faithful to the paper: N0 uniform-grid init samples, GP refit every
iteration, hybrid acquisition with decayed weights, incumbent-repeat
early stop (N_max), evaluation budget T.

The per-scenario Algorithm-1 bookkeeping (eval ledger, incumbent,
discrete neighbor probes, early-stop counters) lives in
``ScenarioState`` so the sequential loop here and the batched
``BatchedBayesSplitEdge`` drive one implementation — trace-equivalence
between the two engines is structural, not maintained by hand.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core import gp as gpm
from repro_torch.core.acquisition import AcqWeights, candidate_grid, maximize
from repro_torch.core.problem import SplitInferenceProblem
from repro_torch.device import resolve_device

# canonical Basic-BO engine flags (constraint-agnostic, no gradient term,
# no schedules, no early stop) — shared by the batched benchmark paths
BASIC_BO_KW = dict(constraint_aware=False, use_grad_term=False,
                   use_schedules=False, n_max_repeat=10 ** 9)


@dataclasses.dataclass
class BOResult:
    best_a: Optional[np.ndarray]      # None <=> no feasible point was found
    best_utility: float               # -inf when best_a is None
    best_accuracy: float
    n_evals: int
    utilities: List[float]            # per-eval observed utility
    accuracies: List[float]
    feasible: List[bool]
    incumbent_trace: List[float]      # best-so-far feasible utility


def _init_grid(n0: int, rng: np.random.Generator) -> np.ndarray:
    """N0 samples from a uniform grid over [0,1]^2 (§5.1), jittered."""
    k = int(np.ceil(np.sqrt(n0)))
    xs = (np.arange(k) + 0.5) / k
    pts = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1).reshape(-1, 2)
    pts = pts[rng.permutation(len(pts))[:n0]]
    return np.clip(pts + rng.normal(0, 0.02, pts.shape), 0, 1)


class ScenarioState:
    """Host-side Algorithm-1 bookkeeping for one BO run.

    Holds the padded GP dataset (numpy mirror of the device layout), the
    eval ledger, the incumbent, the discrete neighbor probe queue (Alg. 1
    mixed-integer local search) and the early-stop counters. Both the
    sequential loop and the batched engine step this object.
    """

    def __init__(self, problem: SplitInferenceProblem, seed: int,
                 budget: int, n_init: int, n_max_repeat: int,
                 gp_cfg: gpm.GPConfig, gp_feasible_only: bool,
                 constraint_aware: bool):
        self.pb = problem
        self.budget = budget
        self.n_init = n_init
        self.n_max_repeat = n_max_repeat
        self.rng = np.random.default_rng(seed)
        self.gp_feasible_only = gp_feasible_only
        self.constraint_aware = constraint_aware
        m = gp_cfg.max_points
        self.x = np.zeros((m, 2))
        self.y = np.zeros((m,))
        self.mask = np.zeros((m,), bool)
        self.n_pts = 0
        self.utilities: List[float] = []
        self.accs: List[float] = []
        self.feas: List[bool] = []
        self.inc_trace: List[float] = []
        self.best_a: Optional[np.ndarray] = None
        self.best_u = -np.inf
        self.seen = set()
        self.probe_queue: List[np.ndarray] = []
        self.inc_layer: Optional[int] = None
        # iteration-invariant: the feasible-boundary candidates depend only
        # on the problem/channel, never on the BO state
        self.boundary = (problem.boundary_candidates() if constraint_aware
                         else None)
        self.n = 0
        self.n_c = 0
        self.active = True

    # -- Alg. 1 inner bookkeeping -------------------------------------------
    def init_design(self) -> None:
        """N0 constraint-aware init samples + first probe push."""
        for a in _init_grid(self.n_init, self.rng):
            if self.constraint_aware:
                a = self.pb.project_feasible(a)
            self.observe(a)
        self.n = self.n_init
        self.push_probes()
        self.active = self.n < self.budget

    def observe(self, a) -> None:
        pb = self.pb
        u = pb.evaluate(a)
        rec = pb.history[-1]
        self.utilities.append(u)
        self.accs.append(rec.accuracy)
        self.feas.append(rec.feasible)
        if rec.feasible and u > self.best_u:
            self.best_u, self.best_a = u, np.asarray(a, float)
        self.inc_trace.append(self.best_u if np.isfinite(self.best_u)
                              else 0.0)
        if rec.feasible or not self.gp_feasible_only:
            self.x[self.n_pts] = np.asarray(a, float)
            self.y[self.n_pts] = u
            self.mask[self.n_pts] = True
            self.n_pts += 1
        self.seen.add((rec.l, round(rec.p_w, 3)))

    def push_probes(self) -> None:
        """Queue +-1 layer neighbors of a new incumbent layer: a single-
        lengthscale Matérn GP cannot represent utility structure narrower
        than the layer spacing, so each new incumbent layer queues its
        neighbors (at the incumbent's power, lifted to min-feasible) —
        mixed-integer BO local search in the spirit of Bounce [37].
        Constraint-aware variant only."""
        if self.best_a is None or not self.constraint_aware:
            return
        pb = self.pb
        l_star, p_star = pb.denormalize(self.best_a)
        if l_star == self.inc_layer:
            return
        self.inc_layer = l_star
        for dl in (1, -1):
            l = l_star + dl
            if 1 <= l <= pb.L:
                # a deeper split may need more power: probe at the
                # analytic min-feasible power for that layer
                a = pb.project_feasible(pb.normalize(l, p_star))
                lp, pp = pb.denormalize(a)
                if (lp, round(pp, 3)) not in self.seen:
                    self.probe_queue.append(a)

    def step(self, a_next) -> None:
        """One observation + incumbent-repeat early stop
        (Alg. 1 lines 14-21)."""
        same = (self.best_a is not None and
                self.pb.denormalize(a_next)
                == self.pb.denormalize(self.best_a))
        self.observe(a_next)
        self.push_probes()
        self.n += 1
        if same:
            self.n_c += 1
            if self.n_c >= self.n_max_repeat:
                self.active = False
        else:
            self.n_c = 0
        if self.n >= self.budget:
            self.active = False

    def drain_probes(self) -> None:
        """Consume queued discrete probes (they bypass the GP/acquisition,
        so neither engine spends a fit or a dispatch on them). Probes are
        always consumed before the next acquisition either way, so this
        preserves the per-scenario eval order."""
        while self.active and self.probe_queue:
            self.step(self.probe_queue.pop(0))

    def dataset(self) -> dict:
        return dict(x=self.x, y=self.y, mask=self.mask)

    def best_feasible(self) -> float:
        # no feasible yet: explore the floor
        return (self.best_u if np.isfinite(self.best_u)
                else float(np.min(self.utilities)))

    def t_norm(self, use_schedules: bool) -> float:
        return ((self.n - self.n_init) / max(self.budget - 1, 1)
                if use_schedules else 0.0)

    def result(self) -> BOResult:
        # no feasible solution found: report it explicitly (best_a=None)
        # rather than a fabricated origin point
        best_acc = 0.0
        if self.best_a is not None:
            _, best_acc = self.pb._accuracy(*self.pb.denormalize(self.best_a))
        return BOResult(
            None if self.best_a is None else np.asarray(self.best_a),
            float(self.best_u), float(best_acc), len(self.utilities),
            self.utilities, self.accs, self.feas, self.inc_trace)


class BayesSplitEdge:
    """The paper's method."""

    name = "Bayes-Split-Edge"

    def __init__(self, problem: SplitInferenceProblem, budget: int = 20,
                 n_init: int = 9, n_max_repeat: int = 5,
                 weights: AcqWeights = AcqWeights(),
                 gp_cfg: gpm.GPConfig = gpm.GPConfig(),
                 grid_n: int = 64, constraint_aware: bool = True,
                 use_grad_term: bool = True, use_schedules: bool = True,
                 device="cuda"):
        self.device = resolve_device(device)
        self.problem = problem
        self.budget = budget
        self.n_init = n_init
        self.n_max_repeat = n_max_repeat
        self.weights = weights
        self.gp_cfg = gp_cfg
        self.grid = candidate_grid(grid_n)
        self.constraint_aware = constraint_aware
        self.use_grad_term = use_grad_term
        self.use_schedules = use_schedules
        # beyond-paper: infeasible evals return utility 0, which poisons the
        # GP near the feasibility boundary; the analytic penalty already
        # encodes infeasibility exactly, so the surrogate trains on feasible
        # observations only (ablated in benchmarks/fig9_ablation.py).
        self.gp_feasible_only = constraint_aware

    def effective_weights(self) -> AcqWeights:
        w = self.weights
        if not self.use_grad_term:
            w = dataclasses.replace(w, lam_g0=0.0, lam_gT=1e-9)
        if not self.constraint_aware:
            w = dataclasses.replace(w, lam_p=0.0)
        return w

    def run(self, seed: int = 0) -> BOResult:
        st = ScenarioState(self.problem, seed, self.budget, self.n_init,
                           self.n_max_repeat, self.gp_cfg,
                           self.gp_feasible_only, self.constraint_aware)
        st.init_design()
        w = self.effective_weights()

        while True:
            st.drain_probes()
            if not st.active:
                break
            m = gpm.bucket_size(st.n_pts, self.gp_cfg.max_points)
            gp = gpm.fit(gpm.as_dataset(gpm.slice_data(st.dataset(), m),
                                        self.device), self.gp_cfg)
            inc = st.best_a if self.constraint_aware else None
            a_next = maximize(gp, st.pb, w, st.t_norm(self.use_schedules),
                              st.best_feasible(), self.grid, incumbent=inc,
                              boundary=st.boundary)
            st.step(a_next)

        return st.result()


class BasicBO(BayesSplitEdge):
    """Standard BO baseline (§6.2): UCB/EI only, constraint-agnostic,
    no gradient term, no weight schedules — see BASIC_BO_KW."""

    name = "Basic-BO"

    def __init__(self, problem, budget: int = 48, **kw):
        for k, v in BASIC_BO_KW.items():
            kw.setdefault(k, v)
        super().__init__(problem, budget=budget, **kw)
