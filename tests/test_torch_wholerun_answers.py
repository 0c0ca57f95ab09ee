"""The reference's answers on the two whole-run mixes ``chip_smoke.py``
runs on the card, which has no JAX: ``tests/data/torch_wholerun_expected.json``
holds the cold, compacted answers and lane logs of the reference's
``WholeRunBayesSplitEdge`` on the hetero mix and the LM request mix.
The test regenerates them from the reference, so the file cannot go
stale, and holds the port's CPU run to them;
``PYTHONPATH=src python tests/test_torch_wholerun_answers.py`` writes
the file anew.
"""
import json
from pathlib import Path

import torch

from repro.core import WholeRunBayesSplitEdge as RefWholeRun
from repro.core import make_hetero_scenarios as ref_hetero
from repro_torch.core import WholeRunBayesSplitEdge, make_hetero_scenarios

torch.set_num_threads(1)
EXPECTED = Path(__file__).parent / "data" / "torch_wholerun_expected.json"
# the reference's MIXED_TRACE_ARCHS (src/repro/wireless/traces.py)
LM_MIX = dict(seeds=[0], budgets=[6, 12],
              archs=["vgg19", "resnet101", "qwen2-moe-a2.7b",
                     "recurrentgemma-2b", "rwkv6-3b", "kimi-k2-1t-a32b"])
HETERO = dict(seeds=[0, 1], budgets=[6, 10, 14, 20],
              archs=["vgg19", "resnet101"])


def _answers(results):
    return dict(best_accuracy=[r.best_accuracy for r in results],
                feasible=[r.best_a is not None for r in results],
                n_evals=[r.n_evals for r in results])


def reference_answers() -> dict:
    """The reference's cold answers and lane logs on the hetero and LM
    mixes (what the JSON file holds)."""
    out = {"about": "Cold (warm_start=False), compacted answers of the "
                    "reference WholeRunBayesSplitEdge "
                    "(src/repro/core/wholerun.py) on the scenarios of "
                    "make_hetero_scenarios(seeds, budgets, archs); "
                    "written by tests/test_torch_wholerun_answers.py"}
    for name, mix in (("hetero", HETERO), ("lm", LM_MIX)):
        eng = RefWholeRun(ref_hetero(**mix), warm_start=False)
        res = eng.run()
        out[name] = dict(mix, **_answers(res),
                         lane_log=eng.lane_stats()["lane_log"])
    return out


def test_expected_answers_are_the_reference_s():
    """The committed answers are what the reference gives now, and the
    port on the CPU gives the same answers and lane log."""
    want = json.loads(EXPECTED.read_text())
    got = reference_answers()
    assert got == want
    from repro.wireless.traces import MIXED_TRACE_ARCHS
    assert tuple(LM_MIX["archs"]) == MIXED_TRACE_ARCHS
    for name in ("hetero", "lm"):
        mix = {k: want[name][k] for k in ("seeds", "budgets", "archs")}
        eng = WholeRunBayesSplitEdge(make_hetero_scenarios(**mix),
                                     warm_start=False, device="cpu")
        assert _answers(eng.run()) == {k: want[name][k] for k in
                                      ("best_accuracy", "feasible",
                                       "n_evals")}
        assert eng.lane_stats()["lane_log"] == want[name]["lane_log"]


if __name__ == "__main__":
    EXPECTED.parent.mkdir(exist_ok=True)
    EXPECTED.write_text(json.dumps(reference_answers(), indent=1) + "\n")
    print(f"wrote {EXPECTED}")
