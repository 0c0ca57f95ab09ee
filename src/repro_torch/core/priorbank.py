"""Transfer-learned prior bank: amortize historical BO runs. Counterpart
of ``repro/core/priorbank.py``: host numpy, the same keys, aggregation
and checkpoint layout, so a bank saved by either package loads in the
other.

Every served request historically started from the same cold GP even
though a fleet-scale server has seen millions of (channel, arch, budget)
runs. The bank is a persistent, checkpoint-compatible store of fitted GP
hyperparameters and mean-prior statistics keyed on **quantized scenario
features** — populated online as lanes retire (``core/wholerun.py`` /
``runtime/stream.py``) and queried at admission to warm-start the fit
theta, shrink the GP mean toward the historical utility level, and seed
the init design with the historical incumbent.

Determinism contract (the admission-order fix):

* **Keying** is a pure function of the scenario: ``(n_layers,
  quantized gain_db, budget bucket, quantized log energy/delay
  budgets)``, every float going through ``torch_cost.quantize_key``
  (half-to-even, the ``seen_key`` idiom) — no iteration counters, no
  arrival timestamps, no insertion order.
* **Aggregation** keeps ONE entry per key: the retired run whose
  ``(best_u, best_a, theta, mu)`` tuple is lexicographically largest,
  plus a permutation-invariant run count. A set of retired runs
  therefore produces the same bank under ANY admission order
  (property-tested in ``tests/test_torch_priorbank.py``).
* **Fallback** is bitwise: a lookup miss (or ``bank=None``) leaves the
  admitted lane on the exact cold path — zero prior pseudo-observations
  and an untouched init design reproduce the historical program
  bit-for-bit (``gp._standardize``'s ``n0 == 0`` contract).

Persistence rides the atomic-commit checkpoint layer
(``checkpoint/ckpt.py``): ``save``/``load`` write the bank as one
flat-array tree with ``kind="priorbank"`` metadata, and ``state_tree``/
``load_state`` embed the same arrays inside the streaming engine's
serving checkpoints so kill + resume carries the learned priors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.core import torch_cost as tc

BANK_VERSION = 1

_THETA_KEYS = ("log_ls", "log_sv", "log_nv")
# key layout: (n_layers, q(gain_db), budget bucket, q(log10 e_max),
# q(log10 tau_max)) — fields 0 and 2 are integral
_KEY_INT_FIELDS = (0, 2)
_KEY_DIM = 5


@dataclasses.dataclass(frozen=True)
class BankPrior:
    """One admission-time lookup hit (see ``PriorBank.lookup``)."""
    theta: tuple          # (log_ls, log_sv, log_nv) of the banked run
    mu0: float            # historical mean feasible utility (mean prior)
    n0: float             # pseudo-observation weight of the mean prior
    best_a: np.ndarray    # banked incumbent (normalized), init-design seed
    best_u: float
    runs: int             # permutation-invariant count under this key


class PriorBank:
    """The store. Host-side and tiny (one ~12-float entry per key);
    device programs only ever see per-lane (theta0, mu0, n0) rows that
    the staging path derives from lookups."""

    def __init__(self, prior_obs_cap: float = 8.0,
                 seed_incumbent: bool = True,
                 gain_quantum_db: float = 0.5,
                 budget_bucket: int = 4,
                 frozen: bool = False):
        if budget_bucket < 1:
            raise ValueError("budget_bucket must be >= 1")
        self.prior_obs_cap = float(prior_obs_cap)
        self.seed_incumbent = bool(seed_incumbent)
        self.gain_quantum_db = float(gain_quantum_db)
        self.budget_bucket = int(budget_bucket)
        self.frozen = bool(frozen)
        self._entries: dict = {}
        self.hits = 0
        self.misses = 0
        self.records = 0

    # -- keying --------------------------------------------------------------
    def key_of(self, sc) -> tuple:
        """The quantized scenario-feature key (pure function of the
        scenario — the admission-order determinism contract)."""
        pb = sc.problem
        b = pb.cm.budgets
        return (int(pb.L),
                tc.quantize_key(pb.gain_db, self.gain_quantum_db),
                int(math.ceil(sc.budget / self.budget_bucket)),
                tc.quantize_key(math.log10(b.e_max_j), 0.25),
                tc.quantize_key(math.log10(b.tau_max_s), 0.25))

    # -- population (lane retirement) ---------------------------------------
    def record_result(self, sc, theta_row, ev_u, ev_feas, best_a,
                      best_u, has_best) -> bool:
        """Fold one retired run into the bank. ``theta_row`` is the
        lane's final warm-start carry as ``(log_ls, log_sv, log_nv)``;
        the ledger slices cover the run's ``n`` evals. Returns whether
        the run was banked (frozen banks, runs without a feasible
        incumbent, and non-finite fits are skipped)."""
        if self.frozen or not has_best or best_a is None:
            return False
        theta = tuple(float(v) for v in np.asarray(theta_row).ravel()[:3])
        best_u = float(best_u)
        if not (np.all(np.isfinite(theta)) and np.isfinite(best_u)):
            return False
        ev_u = np.asarray(ev_u, np.float64)
        ev_feas = np.asarray(ev_feas, bool)
        feas_u = ev_u[ev_feas]
        mu = float(feas_u.mean()) if feas_u.size else best_u
        if not np.isfinite(mu):
            return False
        ba = tuple(float(v) for v in np.asarray(best_a, np.float64)[:2])
        cand = dict(best_u=best_u, best_a=ba, theta=theta, mu=mu, n=1)
        key = self.key_of(sc)
        cur = self._entries.get(key)
        self.records += 1
        if cur is None:
            self._entries[key] = cand
            return True
        # order-independent aggregation: keep the lexicographically
        # largest (best_u, best_a, theta, mu) payload — a total order, so
        # any record sequence converges to the same winner — and a
        # permutation-invariant run count
        n = cur["n"] + 1
        a = (cand["best_u"], cand["best_a"], cand["theta"], cand["mu"])
        b = (cur["best_u"], cur["best_a"], cur["theta"], cur["mu"])
        self._entries[key] = dict(cand if a > b else cur, n=n)
        return True

    # -- query (admission) ---------------------------------------------------
    def lookup(self, sc) -> Optional[BankPrior]:
        """The admission-time query: the banked prior for the scenario's
        key, or ``None`` (a miss — the caller stays on the cold path)."""
        e = self._entries.get(self.key_of(sc))
        if e is None:
            self.misses += 1
            return None
        self.hits += 1
        return BankPrior(
            theta=e["theta"], mu0=e["mu"],
            n0=min(float(e["n"]), self.prior_obs_cap),
            best_a=np.asarray(e["best_a"], np.float64),
            best_u=e["best_u"], runs=e["n"])

    # -- lifecycle -----------------------------------------------------------
    def freeze(self) -> "PriorBank":
        """Lookups only from now on (``record_result`` becomes a no-op).
        A frozen bank is a pure function of scenario -> prior, which is
        what the replay/permutation property tests and the held-out
        transfer benchmarks run against."""
        self.frozen = True
        return self

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> dict:
        return dict(n_keys=len(self._entries), records=self.records,
                    hits=self.hits, misses=self.misses,
                    frozen=self.frozen)

    # -- persistence ---------------------------------------------------------
    def state_tree(self) -> dict:
        """The bank as a flat-array pytree (float64 keys/payloads, int64
        counts) — embeddable in any checkpoint tree (the streaming
        engine's serving snapshots) and the payload of ``save``."""
        k = len(self._entries)
        keys = np.zeros((k, _KEY_DIM), np.float64)
        theta = np.zeros((k, 3), np.float64)
        mu = np.zeros((k,), np.float64)
        best_a = np.zeros((k, 2), np.float64)
        best_u = np.zeros((k,), np.float64)
        n = np.zeros((k,), np.int64)
        # sort rows by key so the serialized form is itself
        # insertion-order independent (byte-stable across permutations)
        for i, key in enumerate(sorted(self._entries)):
            e = self._entries[key]
            keys[i] = key
            theta[i] = e["theta"]
            mu[i] = e["mu"]
            best_a[i] = e["best_a"]
            best_u[i] = e["best_u"]
            n[i] = e["n"]
        return dict(keys=keys, theta=theta, mu=mu, best_a=best_a,
                    best_u=best_u, n=n)

    def load_state(self, tree: dict) -> "PriorBank":
        """Rebuild the entry table from a ``state_tree`` pytree (replacing
        the current contents)."""
        self._entries = {}
        keys = np.asarray(tree["keys"], np.float64)
        for i in range(keys.shape[0]):
            key = tuple(int(v) if j in _KEY_INT_FIELDS else float(v)
                        for j, v in enumerate(keys[i]))
            self._entries[key] = dict(
                best_u=float(tree["best_u"][i]),
                best_a=tuple(np.asarray(tree["best_a"][i], np.float64)),
                theta=tuple(np.asarray(tree["theta"][i], np.float64)),
                mu=float(tree["mu"][i]),
                n=int(tree["n"][i]))
        # every banked run bumped exactly one entry's n, so the restored
        # run count is the column sum (hits/misses stay process-local)
        self.records = int(np.asarray(tree["n"], np.int64).sum())
        return self

    def _meta(self) -> dict:
        return dict(kind="priorbank", version=BANK_VERSION,
                    n_keys=len(self._entries),
                    gain_quantum_db=self.gain_quantum_db,
                    budget_bucket=self.budget_bucket)

    def save(self, ckpt_dir: str, step: int = 0) -> None:
        """Persist through the atomic-commit checkpoint path
        (``checkpoint/ckpt.py``): partial writes are invisible, the
        latest committed step wins."""
        from repro_torch.checkpoint import ckpt as ckptlib
        ckptlib.save(ckpt_dir, step, self.state_tree(),
                     metadata=self._meta())

    @classmethod
    def load(cls, ckpt_dir: str, **kw) -> "PriorBank":
        """Restore the latest committed bank snapshot. Raises
        ``FileNotFoundError`` when the directory holds no committed
        step and ``ValueError`` when it holds some other consumer's
        checkpoints or an incompatible bank version — callers that want
        best-effort warm starts catch and fall back to an empty bank
        (the cold path)."""
        from repro_torch.checkpoint import ckpt as ckptlib
        _, tree, meta = ckptlib.load_named(ckpt_dir, "priorbank",
                                           version=BANK_VERSION)
        kw.setdefault("gain_quantum_db", meta.get("gain_quantum_db", 0.5))
        kw.setdefault("budget_bucket", meta.get("budget_bucket", 4))
        return cls(**kw).load_state(tree)


def stage_prior(sc, bank: Optional[PriorBank]):
    """The staging-path query shared by every engine: scenario ->
    ``(prior_row, seed_a)`` where ``prior_row`` is the per-lane
    ``(theta0, mu0, n0, hit)`` payload for the stacked inputs (zeros /
    miss on ``bank=None``) and ``seed_a`` is the historical incumbent to
    inject into the init design (``None`` unless a hit with incumbent
    seeding on)."""
    row = dict(theta0=dict(log_ls=0.0, log_sv=0.0, log_nv=0.0),
               prior_mu=0.0, prior_n0=0.0, bank_hit=False)
    if bank is None:
        return row, None
    hit = bank.lookup(sc)
    if hit is None:
        return row, None
    row = dict(theta0=dict(log_ls=float(hit.theta[0]),
                           log_sv=float(hit.theta[1]),
                           log_nv=float(hit.theta[2])),
               prior_mu=float(hit.mu0), prior_n0=float(hit.n0),
               bank_hit=True)
    return row, (np.asarray(hit.best_a, np.float64)
                 if bank.seed_incumbent else None)
