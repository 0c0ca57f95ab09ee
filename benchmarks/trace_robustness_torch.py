"""Robustness over the channel trace on the PyTorch port: Bayes-Split-Edge
re-run at frames spanning the synthesized mMobile trace's gain range (the
best frame, the quartiles and the blockage-worst), each within the same
20-evaluation budget, as ``benchmarks/trace_robustness.py`` runs it on
the reference. ``--device`` picks where the BO runs (the card by
default; ``--device cpu`` on a machine without one).

    PYTHONPATH=src python -m benchmarks.trace_robustness_torch [--device cpu]

Writes ``benchmarks/artifacts/trace_robustness_torch.json`` (with the
card's name and power limit on a CUDA run). Imports neither ``jax`` nor
``repro``.
"""
from __future__ import annotations

import argparse

import numpy as np

from benchmarks import table1_torch as t1
from benchmarks.common import save_json
from repro_torch.core import BayesSplitEdge, SplitInferenceProblem
from repro_torch.core.cost_model import CostModel
from repro_torch.core.profiles import vgg19_profile
from repro_torch.device import resolve_device
from repro_torch.wireless.traces import synth_mmobile_trace


def frames(n_frames: int = 5) -> list:
    """The picked frames of ``synth_mmobile_trace(seed=3)`` and their
    gains: best, upper quartile, median, lower quartile, worst."""
    trace = synth_mmobile_trace(seed=3, n_frames=450)
    idx = np.argsort(trace)
    picks = [idx[-1], idx[3 * len(idx) // 4], idx[len(idx) // 2],
             idx[len(idx) // 4], idx[0]][:n_frames]
    return [(int(fi), float(trace[fi])) for fi in picks]


def runs(n_frames: int = 5, seed: int = 0, device="cuda") -> list:
    """``[(frame, problem, BOResult)]``, one run a frame."""
    out = []
    for fi, gain in frames(n_frames):
        pb = SplitInferenceProblem(CostModel(vgg19_profile()), gain)
        out.append((fi, pb, BayesSplitEdge(pb, budget=20,
                                           device=device).run(seed=seed)))
    return out


def figure(results: list) -> list:
    """A row a frame: the found split, power, accuracy, energy, delay and
    evaluations, or ``feasible: False`` where none was found."""
    rows = []
    for fi, pb, res in results:
        solved = (res.best_a is not None and res.best_accuracy > 0
                  and pb.feasible(res.best_a))
        if not solved:
            rows.append(dict(frame=fi, gain_db=pb.gain_db, feasible=False))
            continue
        l, p = pb.denormalize(res.best_a)
        e, t = pb.constraint_values(res.best_a)
        rows.append(dict(frame=fi, gain_db=pb.gain_db, layer=l,
                         power_w=round(p, 3), acc=res.best_accuracy,
                         energy_j=round(e, 3), delay_s=round(t, 3),
                         evals=res.n_evals, feasible=True))
    return rows


def answers(rows: list) -> list:
    return t1.normalized(rows)


def mismatches(got: list, want: list) -> list:
    """Every number of every frame equal."""
    return t1.differences(got, want)


def run(n_frames: int = 5, seed: int = 0, device="cuda") -> list:
    dev = resolve_device(device)
    rows = figure(runs(n_frames, seed, dev))
    save_json("trace_robustness_torch.json", dict(
        rows=rows, device=str(dev),
        card=t1.card() if dev.type == "cuda" else None))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the BO runs (default: cuda)")
    args, _ = ap.parse_known_args(argv)
    rows = run(device=args.device)
    print(f"{'frame':>6s} {'gain dB':>8s} {'l':>3s} {'P(W)':>6s} "
          f"{'acc%':>6s} {'E(J)':>6s} {'tau(s)':>7s}")
    for r in rows:
        if not r.get("feasible"):
            print(f"{r['frame']:6d} {r['gain_db']:8.1f}   (no feasible "
                  f"configuration at this fade depth)")
            continue
        print(f"{r['frame']:6d} {r['gain_db']:8.1f} {r['layer']:3d} "
              f"{r['power_w']:6.3f} {r['acc']:6.2f} {r['energy_j']:6.2f} "
              f"{r['delay_s']:7.2f}")
    return rows


if __name__ == "__main__":
    main()
