"""The constrained split-inference optimization problem — Eq. (5).
The port's copy of ``repro/core/problem.py`` (host numpy); only
``device_params`` (the reference's ``jax_params``) differs.

Decision variables: split layer l in {1..L}, transmit power P in
[P_min, P_max]; normalized to a = [P~, l~] in [0,1]^2 (§5.1). Constraints
are the analytic cost model; the utility is the black-box oracle.

Utility oracle (DESIGN.md §6 — calibrated, deterministic):
  * hard failure (energy budget blown, or <90%% of the pipeline completes
    by the deadline): U = 0            [matches the 0%%-accuracy dips, Fig 6]
  * deadline truncation (completes >=90%% but not fully): the tail layers
    are skipped (dropout-like, §6.1): U = base accuracy
  * full completion: U = base + bump * exp(-(l - l*)^2 / 2 sigma^2)
    - eps_E * E/E_max   (feature-robustness bump peaking at moderate depth;
    the tiny energy term breaks ties toward min-energy feasible power,
    reproducing the exhaustive-search band P in [0.35, 0.39])
  Reported accuracies are quantized to 1/64 (the paper evaluates a
  64-sample batch: 87.50 = 56/64, 85.94 = 55/64, 84.38 = 54/64).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.core.cost_model import Budgets, CostModel


@dataclasses.dataclass(frozen=True)
class UtilityParams:
    base_acc: float = 84.375          # 54/64
    bump: float = 3.125               # -> 56/64 at the peak
    peak_layer: int = 7
    sigma: float = 1.0
    eps_energy: float = 0.1           # tie-break, < one quantization step
    quantum: float = 100.0 / 64.0     # report in 1/64 steps
    completion_floor: float = 0.9     # >=90% done => truncated-but-usable


@dataclasses.dataclass
class EvalRecord:
    a: np.ndarray                     # normalized input
    l: int
    p_w: float
    utility: float                    # internal (smooth) utility
    accuracy: float                   # quantized reported accuracy
    energy_j: float
    delay_s: float
    feasible: bool


class SplitInferenceProblem:
    """Black-box U(a) + analytic constraints, with an eval ledger."""

    def __init__(self, cost_model: CostModel, gain_db: float,
                 util: UtilityParams = UtilityParams(),
                 p_min: float = 0.0, p_max: float = 0.5,
                 executor: Optional[Callable] = None):
        self.cm = cost_model
        self.gain_db = gain_db
        self.util = util
        self.p_min, self.p_max = p_min, p_max
        self.L = cost_model.profile.n_layers
        self.history: List[EvalRecord] = []
        self.executor = executor      # optional: run the real partitioned NN

    # --- input normalization (§5.1) ---------------------------------------
    def denormalize(self, a) -> Tuple[int, float]:
        a = np.clip(np.asarray(a, dtype=np.float64), 0.0, 1.0)
        p = self.p_min + a[0] * (self.p_max - self.p_min)
        l = int(np.clip(np.rint(1 + a[1] * (self.L - 1)), 1, self.L))
        return l, float(p)

    def normalize(self, l: int, p: float) -> np.ndarray:
        return np.array([(p - self.p_min) / (self.p_max - self.p_min),
                         (l - 1) / (self.L - 1)])

    # --- analytic constraints (known, deterministic — §5) ------------------
    def constraint_values(self, a) -> Tuple[float, float]:
        l, p = self.denormalize(a)
        return (float(self.cm.energy_j(l, p, self.gain_db)),
                float(self.cm.delay_s(l, p, self.gain_db)))

    def penalty(self, a) -> float:
        """Eq. (11): ReLU'd budget violations."""
        e, t = self.constraint_values(a)
        b = self.cm.budgets
        return max(0.0, e - b.e_max_j) + max(0.0, t - b.tau_max_s)

    def penalty_batch(self, A) -> np.ndarray:
        """Vectorized Eq. (11) over candidates A: (N,2) normalized."""
        A = np.clip(np.asarray(A, dtype=np.float64), 0.0, 1.0)
        p = self.p_min + A[:, 0] * (self.p_max - self.p_min)
        l = np.clip(np.rint(1 + A[:, 1] * (self.L - 1)), 1, self.L).astype(int)
        e = self.cm.energy_j(l, p, self.gain_db)
        t = self.cm.delay_s(l, p, self.gain_db)
        b = self.cm.budgets
        pen = np.maximum(0.0, e - b.e_max_j) + np.maximum(0.0, t - b.tau_max_s)
        return np.where(np.isfinite(pen), pen, 1e6)

    def project_feasible(self, a, margin: float = 1.02) -> np.ndarray:
        """Lift the power coordinate to the analytic min-feasible power for
        the point's layer (identity if already feasible or if the layer has
        no feasible power). Constraint-aware initialization (Fig 7:
        'every sample lies within feasible regions')."""
        from repro_torch.wireless.channel import required_power_w
        if self.feasible(a):
            return np.asarray(a, dtype=np.float64)
        l, p = self.denormalize(a)
        slack = (self.cm.budgets.tau_max_s - self.cm.device_delay_s(l)
                 - self.cm.server_delay_s(l))
        if slack <= 0:
            return np.asarray(a, dtype=np.float64)
        p_req = float(required_power_w(self.cm.tx_bits(l), slack,
                                       self.gain_db, self.cm.link)) * margin
        if p_req <= self.p_max:
            cand = self.normalize(l, max(p, p_req))
            if self.feasible(cand):
                return cand
        return np.asarray(a, dtype=np.float64)

    def boundary_candidates(self, margin: float = 1.02) -> np.ndarray:
        """One candidate per layer at the min-feasible-power (delay)
        boundary — 'feasible-region exploitation' (§6.3). Uses only the
        *known analytic* constraint model; utility stays black-box."""
        from repro_torch.wireless.channel import required_power_w
        cands = []
        for l in range(1, self.L + 1):
            slack = (self.cm.budgets.tau_max_s - self.cm.device_delay_s(l)
                     - self.cm.server_delay_s(l))
            if slack <= 0:
                continue
            p = required_power_w(self.cm.tx_bits(l), slack, self.gain_db,
                                 self.cm.link) * margin
            if self.p_min <= p <= self.p_max:
                cands.append(self.normalize(l, float(p)))
        return (np.array(cands) if cands
                else np.zeros((0, 2), dtype=np.float64))

    def feasible(self, a) -> bool:
        return self.penalty(a) == 0.0

    def device_params(self, l_pad: Optional[int] = None,
                      device="cuda") -> dict:
        """Device-resident analytic constraint surface (see
        ``torch_cost``), cached per (channel state, pad width, device) so
        the acquisition can take it as an argument every iteration.
        ``l_pad`` pads the per-layer arrays to a batch-wide max-L layout
        for mixed-architecture batches (None: this problem's own L).
        ``device`` defaults to the card and raises where there is none."""
        from repro_torch.core import torch_cost
        from repro_torch.device import resolve_device
        dev = resolve_device(device)
        key = (self.gain_db, l_pad, dev)
        cached = getattr(self, "_device_params", None)
        if cached is None or cached[0] != key:
            self._device_params = (key, torch_cost.make_params(self, l_pad,
                                                               dev))
        return self._device_params[1]

    # --- utility oracle -----------------------------------------------------
    def _accuracy(self, l: int, p: float) -> Tuple[float, float]:
        """Returns (smooth utility, quantized reported accuracy)."""
        u = self.util
        b = self.cm.budgets
        e = float(self.cm.energy_j(l, p, self.gain_db))
        phi = float(self.cm.completion_fraction(l, p, self.gain_db))
        if e > b.e_max_j or phi < u.completion_floor:
            return 0.0, 0.0
        if phi < 1.0:
            # deadline truncation: tail skipped, base accuracy retained
            smooth = u.base_acc * min(1.0, phi / u.completion_floor)
            return smooth, np.floor(smooth / u.quantum + 1e-9) * u.quantum
        bump = u.bump * np.exp(-0.5 * ((l - u.peak_layer) / u.sigma) ** 2)
        raw = u.base_acc + bump
        smooth = raw - u.eps_energy * e / b.e_max_j
        return float(smooth), float(np.floor(raw / u.quantum + 1e-9) * u.quantum)

    def evaluate(self, a, record: bool = True) -> float:
        l, p = self.denormalize(a)
        if self.executor is not None:
            self.executor(l, p)       # run the real partitioned forward
        smooth, acc = self._accuracy(l, p)
        e, t = self.constraint_values(a)
        rec = EvalRecord(np.asarray(a, dtype=np.float64), l, p, smooth, acc,
                         e, t, self.penalty(a) == 0.0)
        if record:
            self.history.append(rec)
        return smooth

    # --- ground truth (for regret / Table 1) --------------------------------
    def exhaustive_optimum(self, n_power: int = 1001):
        best, best_u = None, -np.inf
        ps = np.linspace(0.0, 1.0, n_power)
        for l in range(1, self.L + 1):
            ln = (l - 1) / (self.L - 1)
            for pn in ps:
                u, _ = self._accuracy(*self.denormalize([pn, ln]))
                if u > best_u:
                    best_u, best = u, np.array([pn, ln])
        return best, best_u

    def reset(self):
        self.history = []


def default_vgg19_problem(seed: int = 0, budgets: Budgets = Budgets(),
                          executor=None):
    """The paper's headline setup: VGG19, 5 J / 5 s, mMobile-like channel
    anchored so (l=7, P=0.38 W) is the minimum-energy feasible optimum."""
    from repro_torch.core.profiles import vgg19_profile
    cm = CostModel(vgg19_profile(), budgets=budgets)
    gain_db = cm.calibrate_gain_db(l_star=7, p_star=0.38)
    return SplitInferenceProblem(cm, gain_db, executor=executor)


# nominal mMobile-class link used to derive LM budgets before the
# per-arch channel anchoring (matches the historical serve.py default)
LM_NOMINAL_GAIN_DB = -100.0


def derive_lm_budgets(cm: CostModel, gain_db: float = LM_NOMINAL_GAIN_DB,
                      p_max: float = 0.5) -> Budgets:
    """Auto-budget calibration for an LM split-serving problem (lifted
    from ``launch/serve.py:build_problem`` so every consumer of the
    decoder pool derives the same constraints): ``tau_max`` = 1.25x the
    best achievable end-to-end delay at ``p_max`` on the nominal link,
    ``e_max`` = 2x the energy of an L/8 split at ``p_max`` — a
    tight-but-feasible constrained problem for every arch."""
    prof = cm.profile
    ls = np.arange(1, prof.n_layers + 1)          # valid splits only
    delays = (cm.device_delay_s(ls) + cm.server_delay_s(ls)
              + cm.tx_delay_s(ls, p_max, gain_db))
    best = int(np.argmin(delays))
    # energy budget admits a handful of device-side layers: anchor at
    # an L/8 split so the trade-off is non-degenerate
    l_q = max(1, prof.n_layers // 8)
    e_anchor = float(cm.energy_j(l_q, p_max, gain_db))
    return Budgets(e_max_j=2.0 * e_anchor, tau_max_s=float(1.25 * delays[best]))


def default_lm_problem(arch, seq: int = 128, budgets: Optional[Budgets] = None,
                       executor=None, p_min: float = 0.0, p_max: float = 1.0):
    """Calibrated constrained problem for one arch of the LM decoder
    pool (``arch``: a registry name or a ``ModelConfig``). Budgets are
    auto-derived from the profile (:func:`derive_lm_budgets`) and the
    channel is then anchored per-arch so the L/8 split at P = 0.38 W is
    exactly min-feasible on the delay boundary — the same
    ``calibrate_gain_db`` anchoring the CNN defaults use. The power
    range is wider than the CNN defaults (``p_max`` = 1 W): decode
    continuation ships per-layer KV alongside the residual stream, so
    the uplink payload is heavier."""
    from repro_torch.configs import get_config
    from repro_torch.core.profiles import lm_profile

    cfg = get_config(arch) if isinstance(arch, str) else arch
    prof = lm_profile(cfg, seq)
    cm = CostModel(prof)
    if budgets is None:
        budgets = derive_lm_budgets(cm, p_max=p_max)
    cm = CostModel(prof, budgets=budgets)
    # per-arch anchor: deepest L/8 split whose compute alone still meets
    # the deadline (calibrate_gain_db needs positive transmission slack)
    l_star = max(1, prof.n_layers // 8)
    while l_star > 1 and (budgets.tau_max_s - cm.device_delay_s(l_star)
                          - cm.server_delay_s(l_star)) <= 0:
        l_star -= 1
    gain_db = cm.calibrate_gain_db(l_star=l_star,
                                   p_star=min(0.38, 0.76 * p_max))
    util = UtilityParams(peak_layer=l_star,
                         sigma=max(1.0, prof.n_layers / 16.0))
    return SplitInferenceProblem(cm, gain_db, util=util, executor=executor,
                                 p_min=p_min, p_max=p_max)


def default_resnet101_problem(seed: int = 0):
    """Second model/dataset pair (ResNet101 / Tiny-ImageNet, Fig 8).
    Lighter pipeline -> tighter budgets; peak calibrated mid-network."""
    from repro_torch.core.profiles import resnet101_profile
    cm = CostModel(resnet101_profile(),
                   budgets=Budgets(e_max_j=0.5, tau_max_s=0.5))
    gain_db = cm.calibrate_gain_db(l_star=14, p_star=0.30)
    util = UtilityParams(base_acc=68.75, bump=4.6875, peak_layer=14,
                         sigma=1.5)
    return SplitInferenceProblem(cm, gain_db, util=util)
