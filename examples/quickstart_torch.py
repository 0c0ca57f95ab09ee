"""Quickstart on the PyTorch port: reproduce the paper's headline result.

Builds the VGG19/ImageNet-Mini split-inference problem (5 J / 5 s
budgets, mMobile-class channel) and runs Bayes-Split-Edge for 20
evaluations, on the card unless ``--device cpu`` is given. The expected
outcome is the Table-1 operating point: split layer 7, P ~ 0.38 W,
87.5% accuracy, E ~ 1.53 J, delay ~ 5.00 s. Counterpart of
``examples/quickstart.py``.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import BayesSplitEdge, default_vgg19_problem


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the BO runs (default: cuda)")
    args = ap.parse_args(argv)
    problem = default_vgg19_problem()
    result = BayesSplitEdge(problem, budget=20,
                            device=args.device).run(seed=0)

    l, p = problem.denormalize(result.best_a)
    e, tau = problem.constraint_values(result.best_a)
    print(f"found:  split layer {l}, P = {p:.3f} W")
    print(f"        accuracy {result.best_accuracy:.2f}%  "
          f"E = {e:.2f} J  delay = {tau:.2f} s")
    print(f"        in {result.n_evals} evaluations "
          f"({np.mean(result.feasible) * 100:.0f}% feasible samples)")
    print("paper (Table 1): layer 7, 0.38 W, 87.50%, 1.53 J, 5.00 s, "
          "20 evals")
    if result.best_accuracy < 87.5 - 1e-6:
        raise SystemExit("did not reach the optimum")
    return result


if __name__ == "__main__":
    main()
