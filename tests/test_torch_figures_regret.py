"""The paper's Fig 8 (cumulative regret and decay exponents on
VGG19/ImageNet-Mini and ResNet101/Tiny-ImageNet) on the port, held to the
reference's in all three modes of ``benchmarks/fig8_regret.py``:
``tests/data/torch_figures_regret_expected.json`` holds, from the
reference's ``run()``, the curves and every BO run's final (split,
quantized accuracy, feasibility, evaluations; recorded by
``table1_torch.finals_recorded`` in the order the runs finish), in
``fig8_regret_torch.answers``' form, for the card, which has no JAX.

The test regenerates them from the reference, so the file cannot go
stale, and holds the port's CPU run of each mode to them by
``fig8_regret_torch.mismatches`` (every number equal). ``--batched`` and
``--mixed-arch`` run at the reference's default 3 seeds; the sequential
mode at 1 seed (3 would take the file past two minutes on one worker:
it is the same engine as the batched mode lane by lane, and phase 4f of
``chip_smoke.py`` runs ``--mixed-arch`` on the card). No test writes
under ``benchmarks/artifacts/``. ``PYTHONPATH=src:. python
tests/test_torch_figures_regret.py`` writes the file anew.
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
from benchmarks import fig8_regret as ref_fig8
from benchmarks import fig8_regret_torch as fig8
from benchmarks import table1_torch
from repro.core import bo as ref_bo
from repro_torch.core import bo as port_bo

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
EXPECTED = Path(__file__).parent / "data" / "torch_figures_regret_expected.json"
MODES = {"sequential": dict(n_seeds=1),
         "batched": dict(n_seeds=3, batched=True),
         "mixed_arch": dict(n_seeds=3, mixed_arch=True)}


def reference_answers() -> dict:
    """What the JSON file holds, from the reference's ``run()``."""
    out = {"about": "the reference's Fig 8 (benchmarks/fig8_regret.py) in "
                    "its three modes, in benchmarks/fig8_regret_torch."
                    "answers' form (the curves and every BO run's final); "
                    "written by tests/test_torch_figures_regret.py"}
    for mode, kw in MODES.items():
        with table1_torch.finals_recorded(ref_bo) as finals:
            curves = ref_fig8.run(**kw)
        out[mode] = dict(seeds=kw["n_seeds"],
                         answers=fig8.answers(curves, finals))
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


@pytest.mark.parametrize("mode", list(MODES))
def test_port_gives_the_reference_s_answers(expected, mode, tmp_path,
                                            monkeypatch):
    monkeypatch.setattr(common, "ART", str(tmp_path))
    with table1_torch.finals_recorded(port_bo) as finals:
        curves = fig8.run(device="cpu", **MODES[mode])
    got = fig8.answers(curves, finals)
    assert fig8.mismatches(got, expected[mode]["answers"]) == []
    assert len(finals) == 2 * 2 * MODES[mode]["n_seeds"]
    saved = json.loads((tmp_path / "fig8_regret_torch.json").read_text())
    assert saved["device"] == "cpu" and saved["card"] is None
    assert not (tmp_path / "fig8_regret.json").exists()


if __name__ == "__main__":
    with tempfile.TemporaryDirectory() as tmp:
        common.ART = tmp
        answers = json.dumps(reference_answers())
    if "--stdout" in sys.argv:
        print(answers)
    else:
        EXPECTED.write_text(answers + "\n")
        print(f"wrote {EXPECTED}")
