"""The reference's answers on the streams ``chip_smoke.py`` phase 4c runs
on the card, which has no JAX: ``tests/data/torch_stream_expected.json``
holds, from the reference's ``StreamingBayesSplitEdge``,

* ``hetero`` — the cold answers (accuracy, feasibility, eval count),
  incumbent traces and lane log of ``make_hetero_scenarios()`` through
  8 lanes;
* ``trace`` — the warm per-request answers and incumbent traces of a
  128-arrival mixed CNN + LM trace (``arrival_trace("poisson", n=128,
  seed=0, budgets=(6, 10, 14, 20), archs=MIXED_TRACE_ARCHS)``, order
  driven) through 8 lanes at ``l_pad`` 61 and ``budget_max`` 20.

The test regenerates them from the reference, so the file cannot go
stale, and holds the port's CPU run of the hetero stream to them at
parity level 3 (answers and lane log equal, traces within one 1/64
quantum); ``tests/test_torch_stream_trace.py`` holds the port's run of
the trace. ``PYTHONPATH=src python tests/test_torch_stream_answers.py``
writes the file anew.
"""
import json
from pathlib import Path

import numpy as np
import torch

from repro.core import make_hetero_scenarios as ref_hetero
from repro.core.engine_config import EngineConfig as RefConfig
from repro.runtime.stream import StreamingBayesSplitEdge as RefStream
from repro.runtime.stream import requests_from_trace as ref_decode
from repro.wireless.traces import MIXED_TRACE_ARCHS as REF_MIXED
from repro.wireless.traces import arrival_trace as ref_trace
from repro_torch.core import make_hetero_scenarios
from repro_torch.core.engine_config import EngineConfig
from repro_torch.runtime.stream import StreamingBayesSplitEdge
from repro_torch.wireless.traces import MIXED_TRACE_ARCHS

torch.set_num_threads(1)
EXPECTED = Path(__file__).parent / "data" / "torch_stream_expected.json"
QUANTUM = 100.0 / 64.0
HETERO = dict(seeds=[0, 1], budgets=[6, 10, 14, 20],
              archs=["vgg19", "resnet101"], n_lanes=8)
TRACE = dict(kind="poisson", n=128, seed=0, budgets=[6, 10, 14, 20],
             archs=list(REF_MIXED), n_lanes=8, l_pad=61, budget_max=20)
# requests of the warm trace whose eval count the reference and the
# port's CPU run give differently: warm refits stop on a gradient norm,
# so a count may differ across frameworks (measured: 1 of 128)
N_EVALS_MAY_DIFFER = 1


def _answers(results) -> dict:
    return dict(best_accuracy=[r.best_accuracy for r in results],
                feasible=[r.best_a is not None for r in results],
                n_evals=[r.n_evals for r in results],
                incumbent_trace=[list(r.incumbent_trace) for r in results])


def _lane_log(stats):
    return [[e["lanes"], e["live"], e["bucket"], e["iters"]]
            for e in stats["lane_log"]]


def _trace_kw(spec):
    return {k: spec[k] for k in ("kind", "n", "seed", "budgets", "archs")}


def reference_answers() -> dict:
    """What the JSON file holds, from the reference."""
    out = {"about": "Answers of the reference StreamingBayesSplitEdge "
                    "(src/repro/runtime/stream.py): hetero cold "
                    "(warm_start=False) on make_hetero_scenarios(seeds, "
                    "budgets, archs); trace warm on requests_from_trace("
                    "arrival_trace(kind, n, seed, budgets, archs)); lane "
                    "log rows are (lanes, live, bucket, iters); written by "
                    "tests/test_torch_stream_answers.py"}
    mix = {k: HETERO[k] for k in ("seeds", "budgets", "archs")}
    eng = RefStream(ref_hetero(**mix), RefConfig(warm_start=False),
                    n_lanes=HETERO["n_lanes"])
    res = eng.run()
    out["hetero"] = dict(HETERO, **_answers(res),
                         lane_log=_lane_log(eng.stream_stats()))
    tr = ref_trace(**_trace_kw(TRACE))
    eng = RefStream(ref_decode(tr), n_lanes=TRACE["n_lanes"],
                    l_pad=TRACE["l_pad"], budget_max=TRACE["budget_max"])
    out["trace"] = dict(TRACE, **_answers(eng.run()),
                        n_evals_may_differ=N_EVALS_MAY_DIFFER)
    return out


def test_expected_answers_are_the_reference_s():
    assert json.loads(EXPECTED.read_text()) == json.loads(
        json.dumps(reference_answers()))
    assert tuple(TRACE["archs"]) == MIXED_TRACE_ARCHS


def test_port_hetero_stream_gives_the_reference_s_answers():
    want = json.loads(EXPECTED.read_text())["hetero"]
    mix = {k: want[k] for k in ("seeds", "budgets", "archs")}
    eng = StreamingBayesSplitEdge(make_hetero_scenarios(**mix),
                                  EngineConfig(warm_start=False),
                                  n_lanes=want["n_lanes"], device="cpu")
    got = _answers(eng.run())
    for k in ("best_accuracy", "feasible", "n_evals"):
        assert got[k] == want[k], k
    for g, w in zip(got["incumbent_trace"], want["incumbent_trace"]):
        np.testing.assert_allclose(g, w, atol=QUANTUM)
    assert _lane_log(eng.stream_stats()) == want["lane_log"]


if __name__ == "__main__":
    EXPECTED.parent.mkdir(exist_ok=True)
    EXPECTED.write_text(json.dumps(reference_answers()) + "\n")
    print(f"wrote {EXPECTED}")
