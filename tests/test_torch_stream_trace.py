"""The 128-arrival mixed CNN + LM trace of ``chip_smoke.py`` phase 4c
through the port's streaming server on the CPU, warm and order driven
(``l_pad`` 61, ``budget_max`` 20):

* at 8 lanes against the reference's answers in
  ``tests/data/torch_stream_expected.json`` (held to the reference by
  ``tests/test_torch_stream_answers.py``): every request's quantized
  accuracy and feasibility equal, its incumbent trace within
  ``WARM_TRACE_TOL`` over the evaluations both runs made, and at most
  the file's ``n_evals_may_differ`` requests with another eval count
  (warm refits stop on a gradient norm, whose last bits differ across
  frameworks);
* at 64 lanes (four ``LANE_WIDTH`` chunks an acquisition iteration)
  against the 8-lane run, as the card holds them: equal accuracy and
  eval count per request, traces within ``WARM_TRACE_TOL``.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import wholerun as wr
from repro_torch.runtime.stream import (StreamingBayesSplitEdge,
                                        requests_from_trace)
from repro_torch.wireless.traces import MIXED_TRACE_ARCHS, arrival_trace

torch.set_num_threads(1)
EXPECTED = Path(__file__).parent / "data" / "torch_stream_expected.json"
WARM_TRACE_TOL = 0.5


def _spec():
    return json.loads(EXPECTED.read_text())["trace"]


def _run(n_lanes):
    want = _spec()
    tr = arrival_trace(**{k: want[k] for k in ("kind", "n", "seed",
                                                 "budgets", "archs")})
    eng = StreamingBayesSplitEdge(
        requests_from_trace(tr), n_lanes=n_lanes, l_pad=want["l_pad"],
        budget_max=want["budget_max"], device="cpu")
    return eng.run(), eng.stream_stats()


def _div(a, b):
    m = min(len(a), len(b))
    return float(np.max(np.abs(np.asarray(a[:m]) - np.asarray(b[:m]))))


@pytest.fixture(scope="module")
def eight():
    return _run(8)


def test_trace_is_the_mixed_blend():
    want = _spec()
    assert tuple(want["archs"]) == MIXED_TRACE_ARCHS
    assert (want["n"], want["n_lanes"]) == (128, 8)


def test_eight_lanes_give_the_reference_s_answers(eight):
    res, _ = eight
    want = _spec()
    assert [r.best_accuracy for r in res] == want["best_accuracy"]
    assert [r.best_a is not None for r in res] == want["feasible"]
    differ = sum(r.n_evals != n for r, n in zip(res, want["n_evals"]))
    assert differ <= want["n_evals_may_differ"]
    for r, w in zip(res, want["incumbent_trace"]):
        assert _div(r.incumbent_trace, w) <= WARM_TRACE_TOL


def test_sixty_four_lanes_agree_with_eight(eight):
    res8, st8 = eight
    res64, st64 = _run(64)
    assert st64["lane_log"][0]["lanes"] == 64
    assert st64["lane_log"][0]["chunks"] == 64 // wr.LANE_WIDTH
    assert st64["acq_chunks"] == sum(e["acq_iters"] * e["chunks"]
                                     for e in st64["lane_log"])
    assert st8["acq_chunks"] == st8["acq_iters"]
    for a, b in zip(res8, res64):
        assert a.n_evals == b.n_evals
        assert a.best_accuracy == b.best_accuracy
        assert _div(a.incumbent_trace, b.incumbent_trace) < WARM_TRACE_TOL
