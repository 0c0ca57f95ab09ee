"""The paper's Figs 9 (the acquisition ablation) and 10 (the convergence
iteration across seeds) on the port, held to the reference's in both
modes of ``benchmarks/fig9_ablation.py`` and ``fig10_seeds.py``:
``tests/data/torch_figures_ablation_expected.json`` holds, from the
reference's ``run()``, each figure's numbers and every BO run's final
(split, quantized accuracy, feasibility, evaluations; recorded by
``table1_torch.finals_recorded`` in the order the runs finish), in the
port scripts' ``answers`` form, for the card, which has no JAX.

The test regenerates them from the reference, so the file cannot go
stale, and holds the port's CPU runs to them by each script's
``mismatches`` (Fig 10 and the finals exactly; Fig 9's regret within the
tolerances ``fig9_ablation_torch`` states). ``--batched`` runs at the
reference's default seeds (3 and 10), as phase 4f of ``chip_smoke.py``
runs it on the card; Fig 10's sequential mode too, and Fig 9's at 1 seed
(its five variants at 3 seeds would take the file past two minutes on
one worker). No test writes under ``benchmarks/artifacts/``.
``PYTHONPATH=src:. python tests/test_torch_figures_ablation.py`` writes
the file anew.
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
from benchmarks import fig9_ablation as ref_fig9
from benchmarks import fig9_ablation_torch as fig9
from benchmarks import fig10_seeds as ref_fig10
from benchmarks import fig10_seeds_torch as fig10
from benchmarks import table1_torch
from repro.core import bo as ref_bo
from repro_torch.core import bo as port_bo

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
EXPECTED = (Path(__file__).parent / "data"
            / "torch_figures_ablation_expected.json")
FIGURES = {"fig9": (ref_fig9, fig9, 5), "fig10": (ref_fig10, fig10, 1)}
MODES = {"fig9": {"sequential": dict(n_seeds=1),
                  "batched": dict(n_seeds=3, batched=True)},
         "fig10": {"sequential": dict(n_seeds=10),
                   "batched": dict(n_seeds=10, batched=True)}}
CASES = [(fig, mode) for fig in MODES for mode in MODES[fig]]


def reference_answers() -> dict:
    """What the JSON file holds, from the reference's ``run()``."""
    out = {"about": "the reference's Figs 9 and 10 (benchmarks/"
                    "fig9_ablation.py, fig10_seeds.py) in both modes, in "
                    "their benchmarks/*_torch.py answers' form (the "
                    "figure's numbers and every BO run's final); written "
                    "by tests/test_torch_figures_ablation.py"}
    for fig, modes in MODES.items():
        ref, port, _ = FIGURES[fig]
        out[fig] = {}
        for mode, kw in modes.items():
            with table1_torch.finals_recorded(ref_bo) as finals:
                numbers = ref.run(**kw)
            out[fig][mode] = dict(seeds=kw["n_seeds"],
                                  answers=port.answers(numbers, finals))
    return out


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
def expected():
    return json.loads(EXPECTED.read_text())


def test_expected_answers_are_the_reference_s(expected):
    assert expected == reference_answers_on_one_cpu()


@pytest.mark.parametrize("fig,mode", CASES,
                         ids=[f"{f}-{m}" for f, m in CASES])
def test_port_gives_the_reference_s_answers(expected, fig, mode, tmp_path,
                                            monkeypatch):
    monkeypatch.setattr(common, "ART", str(tmp_path))
    ref, port, runs_a_seed = FIGURES[fig]
    kw = MODES[fig][mode]
    with table1_torch.finals_recorded(port_bo) as finals:
        numbers = port.run(device="cpu", **kw)
    got = port.answers(numbers, finals)
    assert port.mismatches(got, expected[fig][mode]["answers"]) == []
    assert len(finals) == runs_a_seed * kw["n_seeds"]
    name = ref.__name__.split(".")[-1]
    saved = json.loads((tmp_path / f"{name}_torch.json").read_text())
    assert saved["device"] == "cpu" and saved["card"] is None
    assert not (tmp_path / f"{name}.json").exists()


def test_fig9_rule_holds_the_finals_and_hits_exactly(expected):
    """Fig 9's tolerance covers the regret only: a moved hit or final
    fails."""
    want = expected["fig9"]["batched"]["answers"]
    got = json.loads(json.dumps(want))
    first = next(iter(got["variants"]))
    n = len(got["variants"][first]["cum_regret"])
    got["variants"][first]["cum_regret"][-1] += n * table1_torch.QUANTUM / 2
    assert fig9.mismatches(got, want) == []
    got["variants"][first]["cum_regret"][0] += table1_torch.QUANTUM * 1.01
    assert fig9.mismatches(got, want) == [
        f"/variants/{first}/regret_per_step/*"]
    got["variants"][first]["cum_regret"][0] -= table1_torch.QUANTUM * 1.01
    got["variants"][first]["hits"][0] += 1
    got["finals"][0]["best_accuracy"] -= 100 / 64
    assert fig9.mismatches(got, want) == [
        "/finals/*/best_accuracy", f"/variants/{first}/hits/*"]


if __name__ == "__main__":
    with tempfile.TemporaryDirectory() as tmp:
        common.ART = tmp
        answers = json.dumps(reference_answers())
    if "--stdout" in sys.argv:
        print(answers)
    else:
        EXPECTED.write_text(answers + "\n")
        print(f"wrote {EXPECTED}")
