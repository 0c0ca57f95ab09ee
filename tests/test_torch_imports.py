"""The port stands alone: ``repro_torch``, ``chip_smoke.py``, the
port's benchmark scripts (``benchmarks/*_torch.py``) and examples
(``examples/*_torch.py``) import neither ``jax`` nor ``repro``, its entry
points default to the card, and the kernel wrapper takes its plain
version only for CPU tensors."""
import ast
import os
import pkgutil
import runpy
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import (BasicBO, BatchedBayesSplitEdge, BayesSplitEdge,
                              Scenario, WholeRunBayesSplitEdge,
                              default_vgg19_problem, run_packed_shards)
from repro_torch.baselines import PPOBaseline
from repro_torch.kernels.matern_score import matern_score, matern_score_ref
from repro_torch.runtime.fleet import (FleetWorker, SimTransport, sim_fleet,
                                       socket_fleet)
from repro_torch.runtime.stream import StreamingBayesSplitEdge
from repro_torch.models.vgg import init_vgg19
from repro_torch.launch import train as train_launch
from benchmarks import (fig6_convergence_torch, fig7_space_torch,
                        fig8_regret_torch, fig9_ablation_torch,
                        fig10_seeds_torch, run_torch, table1_torch,
                        trace_robustness_torch)

ROOT = Path(__file__).resolve().parents[1]
quickstart_torch, serve_split_torch, train_100m_torch = (
    types.SimpleNamespace(**runpy.run_path(str(ROOT / "examples" / name)))
    for name in ("quickstart_torch.py", "serve_split_torch.py",
                 "train_100m_torch.py"))

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
    assert "repro_torch.models.moe" in mods
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


PORT_SCRIPTS = (sorted((ROOT / "benchmarks").glob("*_torch.py"))
                + [ROOT / "benchmarks" / "run_torch.py"]
                + sorted((ROOT / "examples").glob("*_torch.py")))
SCANNED = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + \
    PORT_SCRIPTS


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


def test_scan_covers_the_fleet_the_baselines_and_table1():
    names = {str(p.relative_to(ROOT)) for p in SCANNED}
    assert {"src/repro_torch/runtime/fleet.py",
            "src/repro_torch/baselines/__init__.py",
            "src/repro_torch/baselines/ppo.py",
            "src/repro_torch/baselines/cmaes.py",
            "src/repro_torch/baselines/direct.py",
            "src/repro_torch/baselines/exhaustive.py",
            "src/repro_torch/baselines/greedy.py",
            "src/repro_torch/baselines/random_search.py",
            "benchmarks/table1_torch.py"} <= names
    assert {"repro_torch.runtime.fleet", "repro_torch.baselines.ppo"} <= set(
        _port_modules())


def test_scan_covers_the_figures_vgg19_and_the_examples():
    names = {str(p.relative_to(ROOT)) for p in SCANNED}
    assert {"src/repro_torch/models/vgg.py",
            "benchmarks/profiling_torch.py",
            "benchmarks/fig6_convergence_torch.py",
            "benchmarks/fig7_space_torch.py",
            "benchmarks/fig8_regret_torch.py",
            "benchmarks/fig9_ablation_torch.py",
            "benchmarks/fig10_seeds_torch.py",
            "benchmarks/trace_robustness_torch.py",
            "benchmarks/run_torch.py",
            "examples/quickstart_torch.py",
            "examples/serve_split_torch.py"} <= names
    assert "repro_torch.models.vgg" in set(_port_modules())


def test_scan_covers_training():
    names = {str(p.relative_to(ROOT)) for p in SCANNED}
    assert {"src/repro_torch/train/__init__.py",
            "src/repro_torch/train/losses.py",
            "src/repro_torch/train/optimizer.py",
            "src/repro_torch/train/trainer.py",
            "src/repro_torch/data/__init__.py",
            "src/repro_torch/data/pipeline.py",
            "src/repro_torch/distributed/collectives.py",
            "src/repro_torch/launch/train.py",
            "src/repro_torch/tree.py",
            "src/repro_torch/kernels/autograd.py",
            "examples/train_100m_torch.py",
            "examples/elastic_restart_torch.py"} <= names
    assert {"repro_torch.train.trainer", "repro_torch.train.losses",
            "repro_torch.train.optimizer", "repro_torch.data.pipeline",
            "repro_torch.distributed.collectives",
            "repro_torch.launch.train"} <= set(_port_modules())


def test_scan_covers_the_dry_run():
    names = {str(p.relative_to(ROOT)) for p in SCANNED}
    assert {"src/repro_torch/launch/dryrun.py",
            "src/repro_torch/kernels/library.py"} <= names
    assert {"repro_torch.launch.dryrun",
            "repro_torch.kernels.library"} <= set(_port_modules())


@pytest.mark.parametrize("path", PORT_SCRIPTS,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_script_imports_with_jax_blocked(path):
    """Each port benchmark script and example, loaded in a fresh
    interpreter with ``jax`` made unimportable, loads no ``repro``/``jax``
    module (``run_path`` runs no ``__main__`` block)."""
    code = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        f"runpy.run_path({str(path)!r})\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'repro' or m.startswith('repro.')\n"
        "             or m.startswith('jax.'))\n"
        "print('LOADED', bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LOADED []" in out.stdout


def test_table1_torch_imports_with_jax_blocked():
    """``benchmarks/table1_torch.py`` in a fresh interpreter with ``jax``
    made unimportable loads no ``repro``/``jax`` module."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import benchmarks.table1_torch\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'repro' or m.startswith('repro.')\n"
        "             or m.startswith('jax.'))\n"
        "print('LOADED', bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LOADED []" in out.stdout


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
    lambda: sim_fleet(_vgg_batch(), n_workers=1, n_lanes=2),
    lambda: FleetWorker("w0", SimTransport(["router", "w0"]), l_pad=37,
                        budget_max=10),
    lambda: socket_fleet(1),
    lambda: PPOBaseline(default_vgg19_problem()),
    lambda: init_vgg19(),
    lambda: table1_torch.run(),
    lambda: fig6_convergence_torch.run(),
    lambda: fig7_space_torch.run(),
    lambda: fig8_regret_torch.run(),
    lambda: fig8_regret_torch.run(batched=True),
    lambda: fig8_regret_torch.run(mixed_arch=True),
    lambda: fig9_ablation_torch.run(),
    lambda: fig9_ablation_torch.run(batched=True),
    lambda: fig10_seeds_torch.run(),
    lambda: fig10_seeds_torch.run(batched=True),
    lambda: trace_robustness_torch.run(),
    lambda: run_torch.main(["fig10_seeds"]),
    lambda: quickstart_torch.main([]),
    lambda: serve_split_torch.main([]),
    lambda: train_launch.main(["--reduced", "--steps", "1", "--ckpt", ""]),
    lambda: train_100m_torch.main(["--steps", "1", "--ckpt", ""]),
], ids=["BayesSplitEdge", "BasicBO", "BatchedBayesSplitEdge",
        "WholeRunBayesSplitEdge", "run_packed_shards", "device_params",
        "StreamingBayesSplitEdge", "sim_fleet", "FleetWorker",
        "socket_fleet", "PPOBaseline", "init_vgg19", "table1_torch",
        "fig6_convergence_torch", "fig7_space_torch", "fig8_regret_torch",
        "fig8_regret_torch-batched", "fig8_regret_torch-mixed_arch",
        "fig9_ablation_torch", "fig9_ablation_torch-batched",
        "fig10_seeds_torch", "fig10_seeds_torch-batched",
        "trace_robustness_torch", "run_torch", "quickstart_torch",
        "serve_split_torch", "launch.train", "train_100m_torch"])
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
