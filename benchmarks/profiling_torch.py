"""Figs 2-4 on the PyTorch port: per-split transmission-delay variability
over the channel trace, the end-to-end delay breakdown and the energy
breakdown, as ``benchmarks/profiling.py`` computes them on the reference.
Host numpy over the port's ``CostModel``, ``vgg19_profile`` and
``synth_mmobile_trace``: no device work, so the numbers are the
reference's exactly.

    PYTHONPATH=src python -m benchmarks.profiling_torch

Writes ``benchmarks/artifacts/profiling_fig234_torch.json``. Imports
neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import numpy as np

from benchmarks.common import save_json
from benchmarks.table1_torch import differences, normalized
from repro_torch.core.cost_model import CostModel
from repro_torch.core.profiles import vgg19_profile
from repro_torch.wireless.traces import synth_mmobile_trace


def figure(p_tx: float = 0.38, n_frames: int = 450) -> dict:
    """The figures' numbers: per split layer, the transmission delay's
    mean and range over the trace, both halves' compute delay, the
    device and mean transmission energy, and the payload bytes."""
    cm = CostModel(vgg19_profile())
    trace = synth_mmobile_trace(seed=0, n_frames=n_frames)
    rows = []
    for l in range(1, cm.profile.n_layers + 1):
        taus = np.array([cm.tx_delay_s(l, p_tx, g) for g in trace])
        rows.append(dict(
            layer=l,
            tx_mean_s=float(taus.mean()), tx_min_s=float(taus.min()),
            tx_max_s=float(taus.max()),
            dev_comp_s=float(cm.device_delay_s(l)),
            srv_comp_s=float(cm.server_delay_s(l)),
            dev_energy_j=float(cm.device_energy_j(l)),
            tx_energy_mean_j=float((p_tx * taus).mean()),
            tx_bytes=float(cm.profile.tx_bytes[l]),
        ))
    return dict(power_w=p_tx, trace_mean_db=float(trace.mean()), layers=rows)


def answers(out: dict) -> dict:
    return normalized(out)


def mismatches(got: dict, want: dict) -> list:
    """Host numbers: every one equal."""
    return differences(got, want)


def run(p_tx: float = 0.38, n_frames: int = 450) -> dict:
    out = figure(p_tx, n_frames)
    save_json("profiling_fig234_torch.json", out)
    return out


def main(argv=None):
    """``argv`` is accepted for ``run_torch``'s sake: the figures are host
    numbers, with no device to pick."""
    out = run()
    rows = out["layers"]
    print(f"channel trace mean {out['trace_mean_db']:.1f} dB, "
          f"P={out['power_w']} W")
    print(f"{'l':>3s} {'tx_mean':>8s} {'tx_range':>18s} {'dev_c':>7s} "
          f"{'srv_c':>7s} {'dev_E':>7s} {'tx_E':>7s}")
    for r in rows[::4] + [rows[-1]]:
        print(f"{r['layer']:3d} {r['tx_mean_s']:8.2f} "
              f"[{r['tx_min_s']:7.2f},{r['tx_max_s']:8.2f}] "
              f"{r['dev_comp_s']:7.2f} {r['srv_comp_s']:7.2f} "
              f"{r['dev_energy_j']:7.3f} {r['tx_energy_mean_j']:7.3f}")
    worst = max(r["tx_max_s"] for r in rows[:8])
    print(f"early-layer worst-case tx delay: {worst:.1f}s "
          f"(paper Fig 2: up to ~45s under blockage)")
    return out


if __name__ == "__main__":
    main()
