"""The port's prior bank (``core/priorbank.py``) against the reference's.

Keys, budget buckets, the lookup's pseudo-observation cap and the
order-free aggregation mirror ``tests/test_priorbank.py``; the same
records give the reference's ``state_tree`` exactly. Within the port's
whole-run engine, bitwise: an empty bank and a frozen never-hitting bank
give the ``bank=None`` run, and a warmed bank never ends worse nor
reaches the cold run's best later. A bank saved by either package loads
in the other with the same ``state_tree``.
"""
import random

import numpy as np
import pytest
import torch

from repro.core.batch_bo import scenario_from_request as ref_request
from repro.core.priorbank import PriorBank as RefBank
from repro.core.priorbank import stage_prior as ref_stage_prior
from repro_torch.core import (Scenario, WholeRunBayesSplitEdge,
                              default_vgg19_problem)
from repro_torch.core import torch_cost as tc
from repro_torch.core.batch_bo import scenario_from_request
from repro_torch.core.engine_config import EngineConfig
from repro_torch.core.priorbank import BANK_VERSION, PriorBank, stage_prior

torch.set_num_threads(1)
COLD = EngineConfig(warm_start=False)
CPU = dict(device="cpu")


def _scens(seeds=(0, 1), budgets=(6, 8)):
    return [Scenario(default_vgg19_problem(), seed=s, budget=b)
            for s in seeds for b in budgets]


def _run(scens, bank=None):
    return WholeRunBayesSplitEdge(scens, COLD, bank=bank, **CPU).run()


def _assert_bitwise(res_a, res_b):
    assert len(res_a) == len(res_b)
    for a, b in zip(res_a, res_b):
        assert a.n_evals == b.n_evals
        assert a.utilities == b.utilities
        assert a.incumbent_trace == b.incumbent_trace


def _records(n, seed=0, request=scenario_from_request):
    """Synthetic retirement records over a few distinct scenario keys."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        sc = request("vgg19", float((-1) ** i * 1.5), 6 + 2 * (i % 3), i)
        theta = tuple(rng.standard_normal(3))
        ev_u = rng.random(5) * 100
        ev_feas = rng.random(5) > 0.3
        best_a = rng.random(2)
        out.append((sc, theta, ev_u, ev_feas, best_a, float(ev_u.max()),
                    True))
    return out


def _same_tree(ta, tb):
    assert set(ta) == set(tb)
    for k in ta:
        a, b = np.asarray(ta[k]), np.asarray(tb[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


def _evals_to(r, target, tol=1e-9):
    tr = np.asarray(r.incumbent_trace)
    hit = np.flatnonzero(tr >= target - tol)
    return int(hit[0]) + 1 if hit.size else len(tr) + 1


# ---------------------------------------------------------------------------
# keying and aggregation, against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gain,budget", [(1.5, 8), (1.49, 5), (1.51, 9),
                                         (-4.0, 8), (0.26, 20)])
def test_keys_equal_reference(gain, budget):
    key = PriorBank().key_of(scenario_from_request("vgg19", gain, budget, 3))
    want = RefBank().key_of(ref_request("vgg19", gain, budget, 3))
    assert key == want
    assert key[1] == tc.quantize_key(
        scenario_from_request("vgg19", gain, budget, 0).problem.gain_db, 0.5)


def test_key_quantization_and_budget_buckets():
    bank = PriorBank()
    a = scenario_from_request("vgg19", 1.5, 8, 0)
    assert bank.key_of(a) == bank.key_of(
        scenario_from_request("vgg19", 1.5, 8, 123))      # seed not in key
    assert bank.key_of(a) != bank.key_of(
        scenario_from_request("vgg19", -4.0, 8, 0))
    assert bank.key_of(scenario_from_request("vgg19", 1.49, 8, 0)) == \
        bank.key_of(scenario_from_request("vgg19", 1.51, 8, 0))

    def k(b):
        return bank.key_of(scenario_from_request("vgg19", 0.0, b, 0))
    assert k(5) == k(8) and k(8) != k(9)              # ceil(b / 4)


@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 16])
def test_state_is_the_reference_s_in_any_record_order(seed):
    """Any record order gives the byte-identical bank, and it is the
    reference's bank for the same records."""
    recs = _records(12, seed=3)
    ref = RefBank()
    for r in _records(12, seed=3, request=ref_request):
        ref.record_result(*r)
    shuffled = list(recs)
    random.Random(seed).shuffle(shuffled)
    bank = PriorBank()
    for r in shuffled:
        bank.record_result(*r)
    _same_tree(bank.state_tree(), ref.state_tree())
    assert bank.stats() == dict(ref.stats(), hits=0, misses=0)


def test_lookup_caps_pseudo_observations():
    bank, ref = PriorBank(prior_obs_cap=3.0), RefBank(prior_obs_cap=3.0)
    rec = _records(1)[0]
    ref_rec = _records(1, request=ref_request)[0]
    for _ in range(10):
        bank.record_result(*rec)
        ref.record_result(*ref_rec)
    hit, want = bank.lookup(rec[0]), ref.lookup(ref_rec[0])
    assert hit.runs == 10 and hit.n0 == 3.0
    assert (hit.theta, hit.mu0, hit.n0, hit.best_u, hit.runs) == \
        (want.theta, want.mu0, want.n0, want.best_u, want.runs)
    np.testing.assert_array_equal(hit.best_a, want.best_a)


def test_stage_prior_equals_reference():
    bank, ref = PriorBank(), RefBank()
    for r in _records(6):
        bank.record_result(*r)
    for r in _records(6, request=ref_request):
        ref.record_result(*r)
    for i in range(6):
        sc = scenario_from_request("vgg19", float((-1) ** i * 1.5),
                                   6 + 2 * (i % 3), 50 + i)
        rsc = ref_request("vgg19", float((-1) ** i * 1.5), 6 + 2 * (i % 3),
                          50 + i)
        (row, seed_a), (want, want_a) = stage_prior(sc, bank), \
            ref_stage_prior(rsc, ref)
        assert row == want
        np.testing.assert_array_equal(seed_a, want_a)


def test_frozen_bank_rejects_records_and_stage_prior_misses():
    bank = PriorBank().freeze()
    recs = _records(2)
    assert not bank.record_result(*recs[0])
    assert len(bank) == 0
    row, seed_a = stage_prior(recs[0][0], bank)
    assert row["bank_hit"] is False and row["prior_n0"] == 0.0
    assert seed_a is None
    assert stage_prior(recs[0][0], None) == (row, None)


# ---------------------------------------------------------------------------
# the whole-run engine with a bank
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cold_base():
    return _run(_scens())


def test_empty_bank_is_bitwise_the_no_bank_run(cold_base):
    bank = PriorBank()
    _assert_bitwise(_run(_scens(), bank), cold_base)
    # staging saw only misses, but the run itself populated the bank
    assert bank.misses == len(_scens()) and len(bank) >= 1


def test_never_hitting_bank_is_bitwise_the_no_bank_run():
    """A bank populated under disjoint keys (another budget bucket)
    stays on the cold path bit for bit."""
    bank = PriorBank()
    _run(_scens(budgets=(14,)), bank)
    assert len(bank) >= 1
    miss = _run(_scens(budgets=(6,)), bank.freeze())
    _assert_bitwise(miss, _run(_scens(budgets=(6,))))
    assert bank.hits == 0


def test_warm_bank_never_worse_and_reaches_target_no_later(cold_base):
    bank = PriorBank()
    _run(_scens(), bank)
    warm = _run(_scens(), bank.freeze())
    assert bank.hits >= len(cold_base)
    for c, w in zip(cold_base, warm):
        assert w.best_utility >= c.best_utility - 1e-9
        assert _evals_to(w, c.best_utility) <= _evals_to(c, c.best_utility)


def test_bank_from_a_run_keys_as_the_reference_s():
    """The same scenarios, run cold by both engines with a bank, bank
    the same keys and run counts."""
    from repro.core import Scenario as RefScenario
    from repro.core import WholeRunBayesSplitEdge as RefWholeRun
    from repro.core import default_vgg19_problem as ref_vgg
    bank, ref = PriorBank(), RefBank()
    _run(_scens(budgets=(10,)), bank)
    RefWholeRun([RefScenario(ref_vgg(), seed=s, budget=10) for s in (0, 1)],
                warm_start=False, bank=ref).run()
    got, want = bank.state_tree(), ref.state_tree()
    np.testing.assert_array_equal(got["keys"], want["keys"])
    np.testing.assert_array_equal(got["n"], want["n"])
    np.testing.assert_allclose(got["best_u"], want["best_u"], rtol=1e-6)


# ---------------------------------------------------------------------------
# persistence, both ways
# ---------------------------------------------------------------------------


def _filled(cls, request):
    bank = cls()
    for r in _records(8, request=request):
        bank.record_result(*r)
    return bank


def test_save_load_roundtrip(tmp_path):
    bank = _filled(PriorBank, scenario_from_request)
    bank.save(str(tmp_path))
    back = PriorBank.load(str(tmp_path))
    _same_tree(back.state_tree(), bank.state_tree())
    assert back.records == bank.records == 8
    assert back.gain_quantum_db == bank.gain_quantum_db


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_bank_loads_across_packages(tmp_path, writer):
    port = _filled(PriorBank, scenario_from_request)
    ref = _filled(RefBank, ref_request)
    _same_tree(port.state_tree(), ref.state_tree())
    if writer == "port":
        port.save(str(tmp_path), step=3)
        back = RefBank.load(str(tmp_path))
    else:
        ref.save(str(tmp_path), step=3)
        back = PriorBank.load(str(tmp_path))
    _same_tree(back.state_tree(), port.state_tree())
    assert back.budget_bucket == 4 and back.records == 8


def test_load_rejects_foreign_and_mismatched_checkpoints(tmp_path):
    from repro_torch.checkpoint import ckpt
    with pytest.raises(FileNotFoundError):
        PriorBank.load(str(tmp_path / "nothing"))
    ckpt.save(str(tmp_path / "a"), 0, {"x": np.zeros(2)},
              metadata=dict(kind="stream"))
    with pytest.raises(ValueError, match="kind"):
        PriorBank.load(str(tmp_path / "a"))
    ckpt.save(str(tmp_path / "b"), 0, PriorBank().state_tree(),
              metadata=dict(kind="priorbank", version=BANK_VERSION + 1))
    with pytest.raises(ValueError, match="version"):
        PriorBank.load(str(tmp_path / "b"))
