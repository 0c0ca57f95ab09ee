"""The reference's Table 1 answers, for the card, which has no JAX:
``tests/data/torch_table1_expected.json`` holds, from the reference's
methods as ``benchmarks/table1.py`` runs them (seed 0),

* ``sequential`` and ``batched`` — the nine rows'
  ``benchmarks.table1_torch.answers`` (the BO rows through
  ``BayesSplitEdge``/``BasicBO``, or through the batched engine; the
  other seven rows are the same in both);
* ``ppo_draws`` — the ``jax.random`` draws of the reference's PPO run
  (both nets' initial weights and the action noise, with the reference's
  key splits), so that the port's PPO runs on them.

The test regenerates them from the reference, so the file cannot go
stale, and holds the port's CPU run of every row to them by the row's
rule (``benchmarks.table1_torch.mismatches``: the host rows exactly,
the BO rows at parity level 3, PPO on the reference's draws within
``PPO_POWER_TOL``). ``PYTHONPATH=src:. python
tests/test_torch_table1_answers.py`` writes the file anew.
"""
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from benchmarks import table1 as ref_table1
from benchmarks import table1_torch
from repro.baselines import (CMAES, ComputeFirst, DirectSearch,
                             ExhaustiveSearch, PPOBaseline, RandomSearch,
                             TransmitFirst)
from repro.baselines.ppo import _init_net
from repro.core import BasicBO, BayesSplitEdge, default_vgg19_problem
from repro.core.bo import BASIC_BO_KW

torch.set_num_threads(1)
EXPECTED = Path(__file__).parent / "data" / "torch_table1_expected.json"
SEED = 0
PPO_BUDGET = 100
ROWS = [name for name, _ in table1_torch.algorithms()]
BO_ROWS = table1_torch.BO_ROWS


def reference_ppo_draws(seed: int, budget: int = PPO_BUDGET) -> dict:
    """The reference PPO run's ``jax.random`` draws, by its key splits:
    the two nets from ``k1``/``k2`` of the first split, then one noise
    draw a step (``src/repro/baselines/ppo.py``)."""
    key = jax.random.PRNGKey(seed)
    key, k1, k2 = jax.random.split(key, 3)
    pi = [np.asarray(x) for wb in _init_net(k1, (2, 32, 2)) for x in wb]
    vf = [np.asarray(x) for wb in _init_net(k2, (2, 32, 1)) for x in wb]
    noise = []
    for _ in range(budget):
        key, k = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(k, (2,))))
    return dict(pi=pi, vf=vf, noise=np.stack(noise))


def _reference_algorithms(batched: bool):
    if batched:
        mk_ours = lambda pb: ref_table1._BatchedRunner(pb, budget=20)  # noqa
        mk_basic = lambda pb: ref_table1._BatchedRunner(  # noqa: E731
            pb, budget=48, **BASIC_BO_KW)
    else:
        mk_ours = lambda pb: BayesSplitEdge(pb, budget=20)  # noqa: E731
        mk_basic = lambda pb: BasicBO(pb, budget=48)        # noqa: E731
    return dict([
        ("Bayes-Split-Edge (Ours)", mk_ours), ("Basic-BO", mk_basic),
        ("Exhaustive Search", lambda pb: ExhaustiveSearch(pb, n_power=1001)),
        ("Direct Search", DirectSearch), ("CMA-ES", CMAES),
        ("Random Search", RandomSearch), ("RL (PPO)", PPOBaseline),
        ("Transmit-First", TransmitFirst), ("Compute-First", ComputeFirst)])


def _reference_row(name, batched):
    pb = default_vgg19_problem()
    res = _reference_algorithms(batched)[name](pb).run(seed=SEED)
    return table1_torch.answers(name, pb, res)


def _listed(draws: dict) -> dict:
    return {k: ([np.asarray(x).tolist() for x in v] if isinstance(v, list)
                else np.asarray(v).tolist()) for k, v in draws.items()}


def reference_answers() -> dict:
    """What the JSON file holds, from the reference."""
    seq = [_reference_row(name, False) for name in ROWS]
    batched = [_reference_row(name, True) if name in BO_ROWS else row
               for name, row in zip(ROWS, seq)]
    return {"about": "Table 1 answers of the reference's methods "
                     "(src/repro/baselines/, src/repro/core/bo.py, the "
                     "batched engine for 'batched'), seed 0, as "
                     "benchmarks/table1.py runs them, in "
                     "benchmarks/table1_torch.answers' keys; ppo_draws are "
                     "the reference PPO run's jax.random draws (pi and vf: "
                     "[w0, b0, w1, b1]; noise: (budget, 2)); written by "
                     "tests/test_torch_table1_answers.py",
            "seed": SEED, "rows": ROWS, "sequential": seq,
            "batched": batched,
            "ppo_draws": _listed(reference_ppo_draws(SEED))}


@pytest.fixture(scope="module")
def expected():
    return json.loads(EXPECTED.read_text())


def test_expected_answers_are_the_reference_s(expected):
    assert expected == json.loads(json.dumps(reference_answers()))


def test_reference_table_matches_the_reference_s_own_run():
    """The rows the file holds are the reference's Table 1 in the
    order of ``benchmarks/table1.py``, with the evals, split layers and
    accuracies a CPU run of it prints."""
    want = json.loads(EXPECTED.read_text())["sequential"]
    got = {r["algorithm"]: r for r in want}
    assert [r["algorithm"] for r in want] == list(ref_table1.PAPER_ROWS)
    table = {"Bayes-Split-Edge (Ours)": (20, 7, 87.5),
             "Basic-BO": (48, 7, 87.5), "Exhaustive Search": (37037, 7, 87.5),
             "Direct Search": (45, 7, 87.5), "CMA-ES": (30, 19, 84.375),
             "Random Search": (300, 7, 87.5), "RL (PPO)": (100, 5, 84.375),
             "Transmit-First": (1, 5, 84.375),
             "Compute-First": (1, 23, 84.375)}
    for name, (n, layer, acc) in table.items():
        r = got[name]
        assert (r["n_evals"], r["split_layer"], r["best_accuracy"]) == (
            n, layer, acc), name


CASES = [(mode, name) for mode in ("sequential", "batched") for name in ROWS]


@pytest.mark.parametrize("mode,name", CASES,
                         ids=[f"{m}-{n}" for m, n in CASES])
def test_port_row_gives_the_reference_s_answers(expected, mode, name):
    ((_, pb, res, _),) = table1_torch.table(
        SEED, batched=mode == "batched", device="cpu",
        ppo_draws=expected["ppo_draws"], rows=[name])
    got = table1_torch.answers(name, pb, res)
    want = next(r for r in expected[mode] if r["algorithm"] == name)
    assert table1_torch.mismatches(got, want) == [], (got, want)


if __name__ == "__main__":
    EXPECTED.parent.mkdir(exist_ok=True)
    EXPECTED.write_text(json.dumps(reference_answers()) + "\n")
    print(f"wrote {EXPECTED}")
