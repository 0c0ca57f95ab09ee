"""Fig 8 on the PyTorch port: cumulative regret on two model/dataset
pairs (VGG19/ImageNet-Mini, ResNet101/Tiny-ImageNet) and the decay
exponents, as ``benchmarks/fig8_regret.py`` computes them on the
reference. ``--batched`` runs each algorithm's seed sweep through the
port's batched engine; ``--mixed-arch`` runs both pairs' sweeps as one
architecture-heterogeneous (max-L padded, packed) batch per algorithm.
``--device`` picks where the BO runs (the card by default; ``--device
cpu`` on a machine without one).

    PYTHONPATH=src python -m benchmarks.fig8_regret_torch \\
        [--batched | --mixed-arch] [--seeds N] [--device cpu]

``runs`` makes the runs and ``figure`` turns them into the curves. The
optimum (``exhaustive_optimum(n_power=301)``) is host code; the regret is
on the reported accuracy, padded with the incumbent's (Eq. 5), and the
decay exponent is ``benchmarks.common.fit_decay_exponent``'s. Writes
``benchmarks/artifacts/fig8_regret_torch.json`` (with the card's name
and power limit on a CUDA run). Imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import argparse

import numpy as np

from benchmarks import table1_torch as t1
from benchmarks.common import cumulative_regret, fit_decay_exponent, save_json
from repro_torch.core import (BatchedBayesSplitEdge, Scenario,
                              default_resnet101_problem,
                              default_vgg19_problem)
from repro_torch.core.bo import BASIC_BO_KW
from repro_torch.core.engine_config import EngineConfig
from repro_torch.device import resolve_device

PAIRS = [("VGG19/ImageNet-Mini", default_vgg19_problem),
         ("ResNet101/Tiny-ImageNet", default_resnet101_problem)]
# how the port's answers are held to the reference's (``mismatches``):
# every number equal. The regret is a host function of the quantized
# accuracies, and the port's runs give the reference's accuracy at every
# step, and the same finals, in all three modes (measured on the CPU)
TOL = {}
# (name, its maker in table1_torch, the batched engine's config)
ALGOS = [("Bayes-Split-Edge", t1.bayes_split_edge, {}),
         ("Basic-BO", t1.basic_bo, BASIC_BO_KW)]


def runs(n_seeds: int = 3, budget: int = 30, batched: bool = False,
         mixed_arch: bool = False, device="cuda") -> dict:
    """``{(pair, algorithm): [BOResult per seed]}``: each seed its own
    run, each (pair, algorithm) sweep one batched run (``batched``), or
    each algorithm's sweep over both pairs one packed batch
    (``mixed_arch``)."""
    out = {}
    if mixed_arch:
        for algo, _, engine_kw in ALGOS:
            scs, tags = [], []
            for pair, mk_pb in PAIRS:
                for seed in range(n_seeds):
                    scs.append(Scenario(mk_pb(), seed=seed, budget=budget))
                    tags.append(pair)
            eng = BatchedBayesSplitEdge(
                scs, config=EngineConfig(pack=True, **engine_kw),
                device=device)
            for tag, res in zip(tags, eng.run()):
                out.setdefault((tag, algo), []).append(res)
        return out
    for pair, mk_pb in PAIRS:
        for algo, make, engine_kw in ALGOS:
            if batched:
                scs = [Scenario(mk_pb(), seed=seed, budget=budget)
                       for seed in range(n_seeds)]
                out[pair, algo] = BatchedBayesSplitEdge(
                    scs, config=EngineConfig(**engine_kw),
                    device=device).run()
            else:
                out[pair, algo] = [
                    make(device, budget=budget)(mk_pb()).run(seed=s)
                    for s in range(n_seeds)]
    return out


def figure(results: dict, budget: int = 30) -> dict:
    """``{pair: {algorithm: {cum_regret, decay_exponent}}}``: the mean
    cumulative regret over the seeds on the reported accuracy, each
    run's trace padded with its incumbent's accuracy to ``budget``."""
    out = {}
    for pair, mk_pb in PAIRS:
        pb0 = mk_pb()
        a_star = pb0.exhaustive_optimum(n_power=301)[0]
        acc_star = pb0._accuracy(*pb0.denormalize(a_star))[1]
        curves = {}
        for algo, _, _ in ALGOS:
            regs = []
            for res in results[pair, algo]:
                accs = list(res.accuracies[:budget])
                accs += [res.best_accuracy] * (budget - len(accs))
                regs.append(cumulative_regret(accs, acc_star))
            n = min(len(r) for r in regs)
            avg_cum = np.mean([r[:n] for r in regs], axis=0)
            avg_reg = avg_cum / np.arange(1, n + 1)
            curves[algo] = dict(cum_regret=avg_cum.tolist(),
                                decay_exponent=fit_decay_exponent(avg_reg))
        out[pair] = curves
    return out


def answers(out, finals: list) -> dict:
    """The figure's numbers and every BO run's final (split layer,
    quantized accuracy, feasibility, evaluations) in the order the runs
    finished (``table1_torch.finals_recorded`` around ``run``)."""
    return t1.normalized(dict(curves=out, finals=finals))


def mismatches(got: dict, want: dict) -> list:
    """The paths of ``answers`` not held to the reference's by ``TOL``
    (every other number equal)."""
    return t1.differences(got, want, TOL)


def run(n_seeds: int = 3, budget: int = 30, batched: bool = False,
        mixed_arch: bool = False, device="cuda") -> dict:
    dev = resolve_device(device)
    out = figure(runs(n_seeds, budget, batched, mixed_arch, dev), budget)
    save_json("fig8_regret_torch.json", dict(
        device=str(dev), batched=batched, mixed_arch=mixed_arch,
        seeds=n_seeds, card=t1.card() if dev.type == "cuda" else None,
        curves=out))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batched", action="store_true",
                    help="each algorithm's seed sweep as one batched run")
    ap.add_argument("--mixed-arch", action="store_true",
                    help="both model/dataset pairs as one "
                         "architecture-heterogeneous (max-L padded) batch")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="where the BO runs (default: cuda)")
    args, _ = ap.parse_known_args(argv)
    out = run(n_seeds=args.seeds, batched=args.batched,
              mixed_arch=args.mixed_arch, device=args.device)
    print(f"{'pair':26s} {'algorithm':18s} {'R_T':>8s} {'decay O(T^x)':>12s} "
          f"(paper: ours -0.85, basic -0.43)")
    for pair, curves in out.items():
        for algo, c in curves.items():
            print(f"{pair:26s} {algo:18s} {c['cum_regret'][-1]:8.2f} "
                  f"{c['decay_exponent']:12.2f}")
    return out


if __name__ == "__main__":
    main()
