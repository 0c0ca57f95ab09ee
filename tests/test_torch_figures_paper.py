"""The paper's Figs 2-4, 6 and 7 and the trace-robustness run on the
port, held to the reference's: ``tests/data/torch_figures_paper_expected.json``
holds, from the reference's own scripts (``benchmarks/profiling.py``,
``fig6_convergence.py``, ``fig7_space.py``, ``trace_robustness.py``, seed
0), each figure's numbers in its port script's ``answers`` form, for the
card, which has no JAX.

The test regenerates them from the reference's ``run()``, so the file
cannot go stale, and holds the port's CPU run of each script to them by
the script's ``mismatches`` (host numbers exactly; Fig 6's per-step
accuracies exactly; Fig 7's BO and PPO powers within the tolerances its
script states). PPO runs on the reference's ``jax.random`` draws
(``tests/data/torch_table1_expected.json``), which are the reference
PPO's own draws at the figures' seed and budget. No test writes under
``benchmarks/artifacts/``: ``benchmarks.common.ART`` points at a
temporary directory. ``PYTHONPATH=src:. python
tests/test_torch_figures_paper.py`` writes the file anew.
"""
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

import benchmarks.common as common
from benchmarks import fig6_convergence as ref_fig6
from benchmarks import fig6_convergence_torch as fig6
from benchmarks import fig7_space as ref_fig7
from benchmarks import fig7_space_torch as fig7
from benchmarks import profiling as ref_profiling
from benchmarks import profiling_torch as profiling
from benchmarks import table1_torch
from benchmarks import trace_robustness as ref_trace
from benchmarks import trace_robustness_torch as trace

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
DATA = Path(__file__).parent / "data"
EXPECTED = DATA / "torch_figures_paper_expected.json"
SEED = 0
FIGURES = {"profiling": profiling, "fig6": fig6, "fig7": fig7,
           "trace_robustness": trace}
ARTIFACTS = {"profiling": "profiling_fig234", "fig6": "fig6_convergence",
             "fig7": "fig7_space", "trace_robustness": "trace_robustness"}


def ppo_draws():
    return json.loads((DATA / "torch_table1_expected.json").read_text())[
        "ppo_draws"]


def reference_answers() -> dict:
    """What the JSON file holds, from the reference's scripts."""
    return {"about": "the reference's Figs 2-4 (benchmarks/profiling.py), "
                     "6, 7 and trace robustness, seed 0, in the answers "
                     "form of their benchmarks/*_torch.py counterparts; "
                     "written by tests/test_torch_figures_paper.py",
            "seed": SEED,
            "profiling": profiling.answers(ref_profiling.run()),
            "fig6": fig6.answers(ref_fig6.run(seed=SEED)),
            "fig7": fig7.answers(ref_fig7.run(seed=SEED)),
            "trace_robustness": trace.answers(ref_trace.run(seed=SEED))}


def port_run(name):
    if name == "profiling":
        return profiling.run()
    if name == "trace_robustness":
        return trace.run(seed=SEED, device="cpu")
    return FIGURES[name].run(seed=SEED, device="cpu", ppo_draws=ppo_draws())


def reference_answers_on_one_cpu() -> dict:
    """``reference_answers()`` in a fresh interpreter held to one CPU of
    this process's set: the reference's JAX compiles then spread no
    threads over the CPUs the other test workers use (spread, they took
    minutes of a loaded CPU; on one CPU they take under a minute)."""
    cpus = sorted(os.sched_getaffinity(0))
    cpu = cpus[os.getpid() % len(cpus)]
    path = os.pathsep.join([str(ROOT / "src"), str(ROOT),
                            os.environ.get("PYTHONPATH", "")])
    out = subprocess.run(
        [sys.executable, __file__, "--stdout"], capture_output=True,
        text=True, timeout=900, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=path),
        preexec_fn=lambda: os.sched_setaffinity(0, {cpu}))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.splitlines()[-1])


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A temporary ``benchmarks.common.ART`` for the module."""
    art = tmp_path_factory.mktemp("artifacts")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, "ART", str(art))
        yield art


@pytest.fixture(scope="module")
def port(artifacts):
    """Each port script's CPU run, once."""
    return {name: port_run(name) for name in FIGURES}


@pytest.fixture(scope="module")
def expected():
    return json.loads(EXPECTED.read_text())


def test_expected_answers_are_the_reference_s(expected):
    assert expected == reference_answers_on_one_cpu()


@pytest.mark.parametrize("name", list(FIGURES))
def test_port_figure_gives_the_reference_s_answers(port, expected, name):
    got = FIGURES[name].answers(port[name])
    assert FIGURES[name].mismatches(got, expected[name]) == []


@pytest.mark.parametrize("name", list(FIGURES))
def test_port_figure_writes_its_own_artifact(port, artifacts, name):
    """``<name>_torch.json`` beside no file of the reference's name, and,
    on the CPU, no card in it."""
    stem = ARTIFACTS[name]
    assert (artifacts / f"{stem}_torch.json").exists()
    assert not (artifacts / f"{stem}.json").exists()
    saved = json.loads((artifacts / f"{stem}_torch.json").read_text())
    if name != "profiling":
        assert saved["device"] == "cpu" and saved["card"] is None


def test_figs_6_and_7_from_table1_runs_equal_their_own_runs(port):
    """Built from a sequential Table 1 (its Bayes-Split-Edge, Basic-BO,
    Direct Search and PPO rows, the same calls), Figs 6 and 7 equal the
    scripts' own runs bit for bit."""
    rows = table1_torch.table(SEED, device="cpu", ppo_draws=ppo_draws(),
                              rows=list(table1_torch.FIGURE_NAMES))
    assert [r[0] for r in rows] == list(table1_torch.FIGURE_NAMES)
    for mod, name in ((fig6, "fig6"), (fig7, "fig7")):
        built = mod.figure(mod.runs(SEED, "cpu", ppo_draws(), table1=rows))
        assert table1_torch.deviations(mod.answers(built),
                                       mod.answers(port[name])) == {}


def test_mismatches_see_a_changed_number(expected):
    """Each script's rule flags a number moved past its tolerance."""
    got = json.loads(json.dumps(expected))
    got["fig6"]["Bayes-Split-Edge"]["acc_per_step"][3] += 1e-9
    got["fig7"]["samples"]["Basic-BO"][5]["p"] += 2 * fig7.BO_POWER_TOL
    got["fig7"]["samples"]["Basic-BO"][6]["p"] += fig7.BO_POWER_TOL / 2
    got["profiling"]["layers"][0]["tx_mean_s"] *= 1 + 1e-15
    got["trace_robustness"][0]["layer"] += 1
    assert fig6.mismatches(got["fig6"], expected["fig6"]) == [
        "/Bayes-Split-Edge/acc_per_step/*"]
    assert fig7.mismatches(got["fig7"], expected["fig7"]) == [
        "/samples/Basic-BO/*/p"]
    assert profiling.mismatches(got["profiling"], expected["profiling"]) == [
        "/layers/*/tx_mean_s"]
    assert trace.mismatches(got["trace_robustness"],
                            expected["trace_robustness"]) == ["/*/layer"]


def test_card_rule_holds_basic_bo_at_parity_level_3(expected):
    """On the card, Figs 6 and 7 hold Basic-BO's run at parity level 3:
    another path of evaluations passes while the step count, the final
    best accuracy and the best so far (within one quantum) hold."""
    want6, want7 = expected["fig6"], expected["fig7"]
    assert fig6.mismatches(want6, want6, on_card=True) == []
    assert fig7.mismatches(want7, want7, on_card=True) == []
    got6 = json.loads(json.dumps(want6))
    steps = got6["Basic-BO"]
    best, quiet = 0.0, []       # feasible steps that raise no best so far
    for i, (acc, ok) in enumerate(zip(steps["acc_per_step"],
                                      steps["feasible"])):
        if ok and acc <= best:
            quiet.append(i)
        best = max(best, acc) if ok else best
    assert len(quiet) >= 2
    for i in quiet[:2]:
        steps["acc_per_step"][i], steps["feasible"][i] = 0.0, False
    got7 = json.loads(json.dumps(want7))
    got7["samples"]["Basic-BO"][3] = dict(l=1, p=0.5, feasible=False)
    assert fig6.mismatches(got6, want6, on_card=True) == []
    assert fig7.mismatches(got7, want7, on_card=True) == []
    assert fig6.mismatches(got6, want6) == [
        "/Basic-BO/acc_per_step/*", "/Basic-BO/feasible/*"]
    assert fig7.mismatches(got7, want7) != []
    steps["acc_per_step"][-1], steps["feasible"][-1] = 100.0, True
    assert fig6.mismatches(got6, want6, on_card=True) == [
        "/Basic-BO/best", "/Basic-BO/best_so_far/*"]
    got7["samples"]["Basic-BO"].pop()
    assert fig7.mismatches(got7, want7, on_card=True) == [
        "/samples/Basic-BO"]
    got6["Bayes-Split-Edge"]["feasible"][0] ^= True
    assert "/Bayes-Split-Edge/feasible/*" in fig6.mismatches(
        got6, want6, on_card=True)


if __name__ == "__main__":
    with tempfile.TemporaryDirectory() as tmp:
        common.ART = tmp
        answers = json.dumps(reference_answers())
    if "--stdout" in sys.argv:
        print(answers)
    else:
        EXPECTED.write_text(answers + "\n")
        print(f"wrote {EXPECTED}")
