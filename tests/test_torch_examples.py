"""The port's examples (``examples/quickstart_torch.py``,
``examples/serve_split_torch.py``, ``examples/train_100m_torch.py`` and
``examples/elastic_restart_torch.py``) on the CPU (``--device cpu``),
each against its reference counterpart: the quickstart finds the
reference's Table 1 operating point, split serving picks the split and
power the reference's ``launch.serve`` picks for the same reduced
architecture, the quick training preset's loss falls, and a preempted
training run resumes from its checkpoint and finishes."""
import runpy
import types
from pathlib import Path

import pytest
import torch

from repro.launch import serve as ref_serve
from repro.core import BayesSplitEdge as RefBayesSplitEdge
from repro.core import default_vgg19_problem as ref_vgg19_problem

torch.set_num_threads(1)
EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def example(name):
    return types.SimpleNamespace(**runpy.run_path(str(EXAMPLES / name)))


def test_quickstart_finds_the_reference_s_optimum(capsys):
    res = example("quickstart_torch.py").main(["--device", "cpu"])
    ref = RefBayesSplitEdge(ref_vgg19_problem(), budget=20).run(seed=0)
    out = capsys.readouterr().out
    assert "found:  split layer 7" in out
    assert res.best_accuracy == ref.best_accuracy == 87.5
    assert res.n_evals == ref.n_evals == 20
    assert res.accuracies == ref.accuracies


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "qwen2-1.5b"])
def test_serve_split_picks_the_reference_s_split(arch, capsys):
    res = example("serve_split_torch.py").main(
        ["--arch", arch, "--device", "cpu"])
    assert "[example] ok" in capsys.readouterr().out
    ref = ref_serve.main(["--arch", arch, "--reduced", "--budget", "15"])
    assert res.n_evals == ref.n_evals <= 15
    assert res.best_accuracy == ref.best_accuracy
    assert res.accuracies == ref.accuracies


def test_train_100m_quick_preset_loss_falls(tmp_path, capsys):
    losses = example("train_100m_torch.py").main(
        ["--preset", "quick", "--steps", "40", "--device", "cpu",
         "--ckpt", str(tmp_path / "ckpt")])
    assert len(losses) == 40 and losses[-1] < losses[0]
    assert "[example] ok" in capsys.readouterr().out


def test_elastic_restart_resumes_training(tmp_path, capsys):
    out = example("elastic_restart_torch.py").main(
        ["--device", "cpu", "--ckpt", str(tmp_path / "ckpt")])
    assert "resumed from step 12" in out
    assert "done at step 25" in out
    assert "[example] ok" in capsys.readouterr().out
