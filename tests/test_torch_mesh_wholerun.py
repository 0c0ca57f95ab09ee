"""The scenario-sharded whole run (``WholeRunBayesSplitEdge(mesh=...)``)
on the CPU.

Two ranks, processes joined over gloo on 127.0.0.1 into a
``scenario_mesh()``, each report to a file under ``tmp_path``; they
mirror ``tests/test_wholerun.py::test_wholerun_sharded_matches_unsharded``
(two VGG19 scenarios, warm) and
``tests/test_mixed_arch.py::test_mixed_shards_match_unsharded`` (the
mixed VGG19 + ResNet101 batch) at their bars: per scenario the eval
count and best accuracy equal the unsharded run's and the incumbent
traces lie within ``WARM_TRACE_TOL``. Every rank gets every result, the
same on both, and here bit for bit the unsharded run's. In one process,
a one-rank ``scenario_mesh()`` equals the unsharded run bit for bit,
compacted or not.
"""
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import (Scenario, WholeRunBayesSplitEdge,
                              default_vgg19_problem, make_mixed_scenarios)
from repro_torch.core.engine_config import EngineConfig
from repro_torch.distributed.sharding import AbstractMesh, scenario_mesh

ROOT = Path(__file__).resolve().parents[1]
WARM_TRACE_TOL = 0.5                 # tests/test_wholerun.py's bound
MIXED_BUDGET = 12                    # tests/test_mixed_arch.py's BUDGET
SPAWN_TIMEOUT = 240
FIELDS = ("n_evals", "best_accuracy", "best_utility", "utilities",
          "incumbent_trace", "feasible")


def _vgg():
    return [Scenario(default_vgg19_problem(), seed=s, budget=14)
            for s in (0, 1)]


def _mixed():
    return make_mixed_scenarios(seeds=(0, 1), budgets=(MIXED_BUDGET,))


BATCHES = {"vgg19": _vgg, "mixed": _mixed}


def _plain(results):
    return [{f: getattr(r, f) for f in FIELDS} for r in results]


def _rank(rank, world, port, out):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    mesh = scenario_mesh()
    report = {}
    for name, make in BATCHES.items():
        eng = WholeRunBayesSplitEdge(make(), mesh=mesh, device="cpu")
        report[name] = dict(results=_plain(eng.run()),
                            lanes=eng.lane_stats())
    Path(out).write_bytes(pickle.dumps(report))
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_wholerun")
    port, world = _free_port(), 2
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    outs = [tmp / f"rank{r}.pkl" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r), str(world), str(port),
         str(outs[r])], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [pickle.loads(o.read_bytes()) for o in outs]


@pytest.fixture(scope="module")
def unsharded():
    torch.set_num_threads(1)
    return {name: _plain(WholeRunBayesSplitEdge(make(), device="cpu").run())
            for name, make in BATCHES.items()}


def _trace_div(a, b):
    m = min(a["n_evals"], b["n_evals"])
    return float(np.max(np.abs(np.asarray(a["incumbent_trace"][:m])
                               - np.asarray(b["incumbent_trace"][:m]))))


@pytest.mark.parametrize("name", list(BATCHES))
def test_two_rank_sharded_run_matches_unsharded(ranks, unsharded, name):
    want = unsharded[name]
    for rep in ranks:
        got = rep[name]["results"]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a["n_evals"] == b["n_evals"]
            assert a["best_accuracy"] == b["best_accuracy"]
            assert _trace_div(a, b) < WARM_TRACE_TOL
    assert ranks[0][name]["results"] == ranks[1][name]["results"]


@pytest.mark.parametrize("name", list(BATCHES))
def test_two_rank_sharded_run_is_bitwise_on_the_cpu(ranks, unsharded, name):
    """Beyond the reference's bar: the fit and the acquisition run on
    16-lane chunks (``wholerun.LANE_WIDTH``), so a lane's numbers do not
    depend on the lanes beside it, and the shards equal the unsharded
    run bit for bit."""
    assert ranks[0][name]["results"] == unsharded[name]


@pytest.mark.parametrize("name", list(BATCHES))
def test_each_rank_ran_its_own_lanes(ranks, name):
    n = len(BATCHES[name]())
    logs = [rep[name]["lanes"] for rep in ranks]
    assert [lg["rank"] for lg in logs] == [0, 1]
    assert [lg["lane_log"][0]["lanes"] for lg in logs] == [n // 2] * 2
    assert sum(lg["lane_log"][0]["live"] for lg in logs) == n


@pytest.mark.parametrize("compact", [True, False])
def test_one_rank_mesh_is_the_unsharded_run_bit_for_bit(compact):
    torch.set_num_threads(1)
    mesh = scenario_mesh()
    assert isinstance(mesh, AbstractMesh) and mesh.size == 1
    for make in BATCHES.values():
        want = WholeRunBayesSplitEdge(make(), EngineConfig(compact=compact),
                                      device="cpu").run()
        got = WholeRunBayesSplitEdge(make(), mesh=mesh, device="cpu").run()
        assert _plain(got) == _plain(want)
        for a, b in zip(got, want):
            assert np.array_equal(a.best_a, b.best_a)


def test_mesh_pads_to_a_multiple_of_its_size():
    eng = WholeRunBayesSplitEdge(_vgg()[:1] * 3, device="cpu",
                                 mesh=AbstractMesh((1,), ("scen",), (0,)))
    assert eng._pad_to() == 4
    with pytest.raises(ValueError):
        WholeRunBayesSplitEdge(_vgg(), device="cpu",
                               mesh=AbstractMesh((2,), ("scen",), (0,))
                               ).run()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        r, w, port, out = sys.argv[2:6]
        _rank(int(r), int(w), int(port), out)
