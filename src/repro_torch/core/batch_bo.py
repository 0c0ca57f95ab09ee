"""Batched Bayes-Split-Edge: S scenarios (seed x gain_db x budgets) run
together on one device. Counterpart of ``repro/core/batch_bo.py``.

Per iteration the engine makes two batched device calls regardless of S:
``gp.fit_batch`` (GP refits over the ``(S, m, d)`` dataset layout) and
``acquisition.maximize_batch`` (block scoring through the
``matern_posterior`` kernel, one launch, then the refinement). Host
bookkeeping is the same ``bo.ScenarioState`` object that drives the
sequential loop, so each scenario's incumbent trace matches a sequential
``BayesSplitEdge.run`` of the same seed structurally.

Scenarios may mix architectures (different layer profiles / ``L``): all
per-layer arrays and the candidate boundary block are padded to the
batch-wide ``L_max`` (``l_pad``) with masked tails. The reference pads
the live set to a power-of-two lane count so that ``jit`` traces few
shapes; eager torch traces nothing, so the port runs exactly the live
lanes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import gp as gpm
from repro_torch.core import torch_cost
from repro_torch.core.acquisition import (REFINE_LR, REFINE_STEPS,
                                          assemble_candidates,
                                          candidate_grid, maximize_batch,
                                          schedule)
from repro_torch.core.bo import BOResult, ScenarioState
from repro_torch.core.engine_config import EngineConfig, resolve_config
from repro_torch.core.problem import SplitInferenceProblem
from repro_torch.device import resolve_device
from repro_torch.kernels import launch_counts

F32 = torch.float32


@dataclasses.dataclass
class Scenario:
    """One BO run: a problem instance (channel state + budgets baked in),
    an init seed and an evaluation budget. ``deadline_s`` is an optional
    absolute completion deadline in trace-time seconds, read by the
    streaming engine's admission; offline engines ignore it."""
    problem: SplitInferenceProblem
    seed: int = 0
    budget: int = 20
    deadline_s: Optional[float] = None


class BatchedBayesSplitEdge:
    """Bayes-Split-Edge over a scenario batch, on ``device``.

    ``run()`` returns one ``BOResult`` per scenario, trace-equivalent to
    ``BayesSplitEdge(problem, budget=...).run(seed=...)`` per scenario
    (up to float32 batched-vs-single numerics).
    """

    name = "Batched-Bayes-Split-Edge"

    def __init__(self, scenarios: Sequence[Scenario],
                 config: Optional[EngineConfig] = None, device="cuda", **kw):
        config = resolve_config(config, kw, "BatchedBayesSplitEdge")
        if kw:
            raise TypeError(f"BatchedBayesSplitEdge() got unexpected "
                            f"keyword arguments {sorted(kw)}")
        if not scenarios:
            raise ValueError("need at least one scenario")
        self.device = resolve_device(device)
        scenarios = list(scenarios)
        # architecture-aware lane packing: sort by (n_layers, budget) so
        # like-L / like-budget lanes sit together. Pure internal staging:
        # `self.scenarios` and the returned results stay in the caller's
        # order; only `_staged` (the batch layout) sorts
        self._pack_order = None
        self._staged = scenarios
        if config.pack:
            from repro_torch.distributed.sharding import pack_order
            self._pack_order = pack_order(scenarios)
            self._staged = [scenarios[i] for i in self._pack_order]
        # mixed-architecture batches: pad every per-layer surface to the
        # batch-wide L_max (a single-arch batch pads to its own L)
        l_max = max(sc.problem.L for sc in scenarios)
        self.l_pad = l_max if config.l_pad is None else config.l_pad
        if self.l_pad < l_max:
            raise ValueError(f"l_pad={config.l_pad} < batch "
                             f"L_max={l_max}")
        self.config = config
        self.scenarios = scenarios
        self.n_init = config.n_init
        self.n_max_repeat = config.n_max_repeat
        self.weights = config.acq_weights()
        self.gp_cfg = config.gp_cfg
        self.grid = candidate_grid(config.grid_n)
        self.constraint_aware = config.constraint_aware
        self.use_schedules = config.use_schedules
        self.gp_feasible_only = config.constraint_aware
        # pluggable surrogate (None = the exact GP through gp.fit_batch)
        self.surrogate = config.surrogate

    # -- device-side helpers -------------------------------------------------
    def _stacked_data(self, states) -> dict:
        """Batched (S, m, d) dataset, m = the active-point bucket shared by
        the batch (see gp.bucket_size — exact w.r.t. the full layout)."""
        m = gpm.bucket_size(max(s.n_pts for s in states),
                            self.gp_cfg.max_points)
        return gpm.as_dataset(dict(
            x=np.stack([s.x[:m] for s in states]),
            y=np.stack([s.y[:m] for s in states]),
            mask=np.stack([s.mask[:m] for s in states])), self.device)

    def _lanes(self, values):
        return torch.as_tensor(np.asarray(values, np.float64)).to(
            self.device, F32)

    def run(self, on_iteration: Optional[Callable[[int, dict], None]] = None
            ) -> List[BOResult]:
        """on_iteration(iteration_index, launch_counts) is called once per
        batched BO iteration with the kernels' launch counts (see
        ``repro_torch.kernels.launch_counts``)."""
        w = self.weights
        cfg = self.gp_cfg
        states = [ScenarioState(sc.problem, sc.seed, sc.budget, self.n_init,
                                self.n_max_repeat, cfg,
                                self.gp_feasible_only, self.constraint_aware)
                  for sc in self._staged]
        for st in states:
            st.init_design()

        # the constraint params depend only on each scenario's channel;
        # re-stack them only when the live set changes
        params_cache: dict = {}
        it = 0
        while True:
            for st in states:
                st.drain_probes()
            live = [st for st in states if st.active]
            if not live:
                break

            key = tuple(id(st) for st in live)
            if key not in params_cache:
                params_cache = {key: torch_cost.stack_params(
                    [st.pb.device_params(device=self.device)
                     for st in live], l_pad=self.l_pad)}
            params_b = params_cache[key]

            data = self._stacked_data(live)
            if self.surrogate is None:
                gps = gpm.fit_batch(data, cfg)
            else:
                gps, _ = self.surrogate.fit(data)

            cand, bf, lb, lg = [], [], [], []
            for st in live:
                inc = st.best_a if self.constraint_aware else None
                cand.append(assemble_candidates(st.pb, self.grid, inc,
                                                self.constraint_aware,
                                                boundary=st.boundary,
                                                l_pad=self.l_pad))
                bf.append(st.best_feasible())
                t_norm = st.t_norm(self.use_schedules)
                lb.append(schedule(w.lam_base0, w.lam_baseT, t_norm))
                lg.append(schedule(w.lam_g0, w.lam_gT, t_norm))

            a_b, _ = maximize_batch(
                gps, params_b, self._lanes(np.stack(cand)), self._lanes(bf),
                self._lanes(lb), self._lanes(lg), w.lam_p, w.beta,
                REFINE_LR, REFINE_STEPS, surrogate=self.surrogate)
            a_b = a_b.cpu().double().numpy()

            # -- host bookkeeping (early-stop masking, probes, ledger) ------
            for i, st in enumerate(live):
                st.step(a_b[i])

            if on_iteration is not None:
                on_iteration(it, launch_counts())
            it += 1

        results = [st.result() for st in states]
        if self._pack_order is not None:
            from repro_torch.distributed.sharding import unpack_results
            results = unpack_results(results, self._pack_order)
        return results


def make_vgg19_scenarios(seeds: Sequence[int] = (0, 1, 2, 3),
                         gain_offsets_db: Sequence[float] = (0.0, -2.0),
                         budgets: Sequence[int] = (20, 30)) -> List[Scenario]:
    """seed x gain_db x budget product on the paper's headline VGG19 setup
    (gain offsets perturb the calibrated channel — e.g. fading frames)."""
    from repro_torch.core.cost_model import CostModel
    from repro_torch.core.problem import default_vgg19_problem
    from repro_torch.core.profiles import vgg19_profile

    base = default_vgg19_problem()
    out = []
    for seed in seeds:
        for off in gain_offsets_db:
            for budget in budgets:
                pb = SplitInferenceProblem(
                    CostModel(vgg19_profile()), base.gain_db + off)
                out.append(Scenario(pb, seed=seed, budget=budget))
    return out


def make_mixed_scenarios(seeds: Sequence[int] = (0, 1),
                         budgets: Sequence[int] = (16,)) -> List[Scenario]:
    """Architecture-heterogeneous batch: the paper's two backbones
    (VGG19/ImageNet-Mini, L=37 and ResNet101/Tiny-ImageNet, L=36)
    interleaved per seed x budget — the canonical mixed max-L-padded
    workload for benchmarks and parity gates."""
    from repro_torch.core.problem import (default_resnet101_problem,
                                    default_vgg19_problem)

    out = []
    for seed in seeds:
        for budget in budgets:
            out.append(Scenario(default_vgg19_problem(), seed=seed,
                                budget=budget))
            out.append(Scenario(default_resnet101_problem(), seed=seed,
                                budget=budget))
    return out


def make_hetero_scenarios(seeds: Sequence[int] = (0, 1),
                          budgets: Sequence[int] = (6, 10, 14, 20),
                          archs: Sequence[str] = ("vgg19", "resnet101")
                          ) -> List[Scenario]:
    """Heterogeneous-budget + mixed-architecture batch: the given
    ``archs`` (any :func:`scenario_from_request` registry name — the
    two CNN backbones by default, or LM decoder archs with L 24..61)
    interleaved across a 6..20 eval-budget spread — the canonical
    lane-compaction workload (budget-6 lanes die at the init design,
    the rest retire in waves), used by bench_engine's hetero and lm
    sections and bench_check's compaction/packing gates."""
    out = []
    for seed in seeds:
        for budget in budgets:
            for arch in archs:
                out.append(scenario_from_request(arch, budget=budget,
                                                 seed=seed))
    return out


def request_archs() -> List[str]:
    """Every architecture :func:`scenario_from_request` can decode: the
    paper's two CNN backbones plus the full LM decoder config pool."""
    from repro_torch.configs import list_configs
    return ["vgg19", "resnet101"] + list_configs()


def _base_request_problem(arch: str):
    """The calibrated base problem for one request architecture,
    memoized per arch — requests of the same backbone share the cost
    model/profile (the decoded per-request problem is a fresh
    ``SplitInferenceProblem`` either way, so eval ledgers never mix)."""
    from repro_torch.core.problem import (default_lm_problem,
                                    default_resnet101_problem,
                                    default_vgg19_problem)

    cache = _base_request_problem._cache
    if arch not in cache:
        if arch == "vgg19":
            cache[arch] = default_vgg19_problem()
        elif arch == "resnet101":
            cache[arch] = default_resnet101_problem()
        else:
            from repro_torch.configs import list_configs
            if arch not in list_configs():
                raise ValueError(
                    f"unknown request architecture {arch!r}; "
                    f"have {request_archs()}")
            cache[arch] = default_lm_problem(arch)
    return cache[arch]


_base_request_problem._cache = {}


def scenario_from_request(arch: str, gain_offset_db: float = 0.0,
                          budget: int = 20, seed: int = 0,
                          deadline_s: Optional[float] = None) -> Scenario:
    """Decode one raw stream request — (channel state, budget,
    architecture) — into a ``Scenario`` on the calibrated default
    problem for that backbone, with the request's channel expressed as
    a dB offset from the calibrated operating point (e.g. a fading
    frame of the mMobile replay trace). The request decoder of the
    streaming admission queue (``repro_torch.runtime.stream``).

    ``arch`` covers the whole registry (:func:`request_archs`): the two
    CNN backbones plus every LM decoder config (``default_lm_problem``
    calibration), so arrival traces and the serving engines carry mixed
    CNN+LM request streams. The decoded problem keeps the base
    problem's ``p_min``/``p_max`` search space — a gain offset shifts
    the channel, never the power bounds."""
    from repro_torch.core.problem import SplitInferenceProblem

    base = _base_request_problem(arch)
    pb = SplitInferenceProblem(base.cm, base.gain_db + gain_offset_db,
                               util=base.util, p_min=base.p_min,
                               p_max=base.p_max)
    return Scenario(pb, seed=seed, budget=budget, deadline_s=deadline_s)


def run_packed_shards(scenarios: Sequence[Scenario], n_shards: int = 1,
                      engine_cls=None, **engine_kw) -> List[BOResult]:
    """Architecture-aware shard packing over separate engine runs:
    scenarios sort by ``(n_layers, budget)`` and split into contiguous
    shards, each run as its own batch padded to the SHARD-local
    ``L_max`` and ``budget_max`` instead of the global batch maxima —
    so a CNN shard never pays an LM-decoder profile's padding and an
    early-budget shard never sizes its ledger for budget 20.

    Results come back in input order: the packing is a pure permutation.
    ``engine_cls`` defaults to ``WholeRunBayesSplitEdge``; ``engine_kw``
    (``device=`` among them) goes to every shard's engine.
    """
    from repro_torch.distributed.sharding import (pack_scenarios,
                                                  unpack_results)
    if engine_cls is None:
        from repro_torch.core.wholerun import WholeRunBayesSplitEdge
        engine_cls = WholeRunBayesSplitEdge
    shards, order = pack_scenarios(scenarios, n_shards)
    packed_results: List[BOResult] = []
    for shard in shards:
        packed_results.extend(engine_cls(shard, **engine_kw).run())
    return unpack_results(packed_results, order)
