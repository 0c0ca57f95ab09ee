"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor ``repro``, its entry points default to the card, and
the kernel wrapper takes its plain version only for CPU tensors."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import (BasicBO, BatchedBayesSplitEdge, BayesSplitEdge,
                              Scenario, WholeRunBayesSplitEdge,
                              default_vgg19_problem, run_packed_shards)
from repro_torch.kernels.matern_score import matern_score, matern_score_ref
from repro_torch.runtime.stream import StreamingBayesSplitEdge

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_every_module_imports_with_jax_blocked():
    """A fresh interpreter with ``jax`` made unimportable imports every
    port module, and afterwards no ``repro``/``repro.*`` module is
    loaded."""
    mods = _port_modules()
    assert "repro_torch.core.gp" in mods and len(mods) > 25
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'repro' or m.startswith('repro.')\n"
        "             or m == 'jax' and sys.modules[m] is not None\n"
        "             or m.startswith('jax.'))\n"
        "print('LOADED', bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LOADED []" in out.stdout


def _imported_names(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


SCANNED = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_scan_covers_the_whole_run_engine_bank_and_checkpoints():
    names = {str(p.relative_to(PORT)) for p in SCANNED if PORT in p.parents}
    assert {"core/wholerun.py", "core/priorbank.py", "checkpoint/ckpt.py",
            "checkpoint/__init__.py"} <= names


def test_scan_covers_the_streaming_server():
    names = {str(p.relative_to(PORT)) for p in SCANNED if PORT in p.parents}
    assert {"runtime/stream.py", "runtime/chaos.py", "wireless/traces.py",
            "distributed/fault_tolerance.py",
            "distributed/sharding.py"} <= names
    assert {"repro_torch.runtime.stream", "repro_torch.runtime.chaos",
            "repro_torch.wireless.traces",
            "repro_torch.distributed.fault_tolerance"} <= set(_port_modules())


@pytest.mark.parametrize("path", SCANNED,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import_in_source(path):
    bad = [n for n in _imported_names(path) if _forbidden(n)]
    assert not bad, f"{path} imports {bad}"


def test_forbidden_predicate():
    assert _forbidden("jax.numpy") and _forbidden("repro.core.gp")
    assert _forbidden("jax") and _forbidden("repro")
    assert not _forbidden("repro_torch.core") and not _forbidden("numpy")


def _vgg_batch():
    return [Scenario(default_vgg19_problem(), seed=0, budget=10)]


@pytest.mark.parametrize("build", [
    lambda: BayesSplitEdge(default_vgg19_problem()),
    lambda: BasicBO(default_vgg19_problem()),
    lambda: BatchedBayesSplitEdge(_vgg_batch()),
    lambda: WholeRunBayesSplitEdge(_vgg_batch()),
    lambda: run_packed_shards(_vgg_batch(), n_shards=1),
    lambda: default_vgg19_problem().device_params(),
    lambda: StreamingBayesSplitEdge(_vgg_batch(), n_lanes=2),
], ids=["BayesSplitEdge", "BasicBO", "BatchedBayesSplitEdge",
        "WholeRunBayesSplitEdge", "run_packed_shards", "device_params",
        "StreamingBayesSplitEdge"])
def test_default_device_raises_without_cuda(build):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        build()


def _score_args(S=2, N=37, n=16, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (torch.as_tensor(rng.random((S, N, 2)).astype(f)),
            torch.as_tensor(rng.random((S, n, 2)).astype(f)),
            torch.as_tensor(rng.standard_normal((S, n)).astype(f)),
            torch.as_tensor((rng.random((S, n)) < 0.8).astype(f)),
            torch.as_tensor((0.1 + rng.random(S)).astype(f)),
            torch.as_tensor((0.5 + rng.random(S)).astype(f)))


def test_matern_score_on_cpu_is_the_plain_version():
    args = _score_args()
    before = matern_score.launches
    got = matern_score(*args)
    assert torch.equal(got, matern_score_ref(*args))
    assert matern_score.launches == before      # nothing was launched


def test_matern_score_rejects_other_devices():
    args = [a.to("meta") for a in _score_args()]
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        matern_score(*args)
