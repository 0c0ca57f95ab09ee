"""Split-serving entry point: Bayes-Split-Edge picks (split layer, tx power)
for an LM from the assigned pool, then serves a batch with the chosen
partition; every BO evaluation runs the real partitioned forward.
Counterpart of ``repro/launch/serve.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --reduced --device cpu

The weights are random, drawn under the reference's init rules from a
``torch.Generator`` seeded with ``--seed``.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.bo import BayesSplitEdge
from repro_torch.core.cost_model import Budgets, CostModel
from repro_torch.core.problem import SplitInferenceProblem, derive_lm_budgets
from repro_torch.core.profiles import lm_profile
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.runtime.splitpoint import SplitRunner


def build_problem(cfg, seq: int, budgets: Budgets = None, executor=None,
                  gain_db: float = -100.0, p_max: float = 0.5):
    """Auto-budgeted split-serving problem for an LM arch on a fixed
    nominal link (-100 dB); budgets from ``derive_lm_budgets`` unless
    given."""
    prof = lm_profile(cfg, seq)
    if budgets is None:
        budgets = derive_lm_budgets(CostModel(prof), gain_db=gain_db,
                                    p_max=p_max)
    cm = CostModel(prof, budgets=budgets)
    return SplitInferenceProblem(cm, gain_db, executor=executor, p_max=p_max)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--budget", type=int, default=15)
    ap.add_argument("--e-max", type=float, default=0.0)
    ap.add_argument("--tau-max", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the generator the weights are drawn from")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    exec_cfg = reduced(cfg) if args.reduced else cfg
    model = tfm.init_model(exec_cfg,
                           torch.Generator(dev).manual_seed(args.seed), dev)
    runner = SplitRunner(exec_cfg, model, args.batch, args.seq)

    budgets = (Budgets(e_max_j=args.e_max, tau_max_s=args.tau_max)
               if args.e_max and args.tau_max else None)
    # the COST model uses the full arch's profile; the EXECUTION runs the
    # real partitioned forward of exec_cfg for every BO evaluation
    pb = build_problem(cfg, args.seq, budgets,
                       executor=lambda l, p: runner.run(
                           min(l, exec_cfg.n_layers), p))
    bo = BayesSplitEdge(pb, budget=args.budget, device=dev)
    res = bo.run(seed=0)
    if res.best_a is None:
        print(f"[serve] {args.arch}: no feasible (split, power) found "
              f"within {res.n_evals} evals — budgets E<={pb.cm.budgets.e_max_j} J"
              f" tau<={pb.cm.budgets.tau_max_s} s are unsatisfiable on this "
              f"channel; not starting the serving loop")
        return res
    l, p = pb.denormalize(res.best_a)
    e, t = pb.constraint_values(res.best_a)
    print(f"[serve] {args.arch}: split l={l}/{cfg.n_layers} "
          f"P={p:.3f} W  E={e:.3f} J  tau={t:.3f} s "
          f"({res.n_evals} evals, feasible={pb.feasible(res.best_a)})")

    # steady-state serving with the chosen partition
    logits, bb = runner.run(min(l, exec_cfg.n_layers), p)
    print(f"[serve] partitioned batch served: logits {tuple(logits.shape)}, "
          f"boundary payload {bb} B")
    return res


if __name__ == "__main__":
    main()
