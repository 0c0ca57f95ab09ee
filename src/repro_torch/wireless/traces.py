"""mMobile-like channel traces and arrival traces: the port's own copy of
``repro.wireless.traces`` (numpy only), so the port imports nothing of the
JAX package. Same seeds, same lists and arrays.

Channel traces are synthesized (DESIGN.md §7).

The mMobile dataset (mmNets'20) is not redistributable offline; we
synthesize traces matching its published setting: outdoor 30 m link,
0.6 m spatial resolution, 45 tracked points, blockage events, fast
fading. The generator is seeded and deterministic. ``eval_gain_db``
anchors the frame used for the headline benchmark so the Table-1
operating point is exact (core/problem.py calibrates it analytically).
"""
from __future__ import annotations

import numpy as np


def synth_mmobile_trace(seed: int = 0, n_frames: int = 450,
                        mean_db: float = -102.64,
                        fading_std_db: float = 2.5,
                        blockage_depth_db: float = 9.0,
                        blockage_rate: float = 0.08,
                        blockage_len: int = 12) -> np.ndarray:
    """Per-frame channel gain |h|^2 in dB. 450 frames ~ 45 tracked points
    x 10 fast-fading samples each."""
    rng = np.random.default_rng(seed)
    # slow shadowing: AR(1) around the link budget mean
    shadow = np.zeros(n_frames)
    rho, sig = 0.97, 1.0
    for t in range(1, n_frames):
        shadow[t] = rho * shadow[t - 1] + sig * np.sqrt(1 - rho ** 2) * rng.standard_normal()
    # fast fading: Rician-ish (log-normal approx in dB)
    fast = fading_std_db * rng.standard_normal(n_frames)
    # blockage events: sudden deep fades lasting ~blockage_len frames
    block = np.zeros(n_frames)
    t = 0
    while t < n_frames:
        if rng.random() < blockage_rate:
            depth = blockage_depth_db * (0.7 + 0.6 * rng.random())
            block[t:t + blockage_len] = -depth
            t += blockage_len
        else:
            t += 1
    return mean_db + shadow + fast + block


def frame_stats(trace_db: np.ndarray) -> dict:
    return dict(mean_db=float(trace_db.mean()),
                min_db=float(trace_db.min()),
                max_db=float(trace_db.max()),
                p10_db=float(np.percentile(trace_db, 10)))


# -- synthetic arrival traces (streaming scenario ingestion) -----------------
#
# An arrival trace is the replayable input of the streaming serving
# engine (repro_torch/runtime/stream.py): per-arrival time, channel state
# (a dB offset from the calibrated operating point, drawn from the
# mMobile-like gain trace above), evaluation budget, backbone and init
# seed. Generators are seeded and deterministic so a failing soak run
# can dump its trace and be replayed exactly.

ARRIVAL_KINDS = ("poisson", "bursty", "replay")

# canonical LM-decoder request mix: L spread 24..61 (qwen2-moe 24 ->
# kimi-k2 61) with an MoE pair and an SSM + hybrid pair, so arch-aware
# shard packing has real padding to win back. Any name
# ``core.batch_bo.request_archs()`` lists is a valid trace arch; these
# tuples are the mixes bench_engine's lm section and the mixed CNN+LM
# serving benchmarks replay.
LM_TRACE_ARCHS = ("qwen2-moe-a2.7b", "recurrentgemma-2b", "rwkv6-3b",
                  "kimi-k2-1t-a32b")
MIXED_TRACE_ARCHS = ("vgg19", "resnet101") + LM_TRACE_ARCHS


def poisson_arrivals(n: int, rate_hz: float = 50.0,
                     seed: int = 0) -> np.ndarray:
    """Homogeneous Poisson process: n arrival times (s), exponential
    inter-arrivals at ``rate_hz``."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate_hz, size=n))


def bursty_arrivals(n: int, burst_len: int = 8, burst_rate_hz: float = 200.0,
                    idle_s: float = 0.25, seed: int = 0) -> np.ndarray:
    """On/off bursts: ``burst_len`` back-to-back arrivals at
    ``burst_rate_hz``, separated by ~``idle_s`` idle gaps (jittered) —
    the flash-crowd pattern that stresses the admission queue depth."""
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    while len(out) < n:
        for _ in range(min(burst_len, n - len(out))):
            t += rng.exponential(1.0 / burst_rate_hz)
            out.append(t)
        t += idle_s * (0.5 + rng.random())
    return np.asarray(out)


def replay_arrivals(n: int, frame_period_s: float = 0.02) -> np.ndarray:
    """mMobile-replay pacing: one arrival per channel frame at the
    trace's fixed frame period (45 points x 10 fast-fading samples)."""
    return frame_period_s * (1.0 + np.arange(n))


def arrival_trace(kind: str = "poisson", n: int = 100, seed: int = 0,
                  budgets=(6, 10, 14, 20), archs=("vgg19", "resnet101"),
                  fading_std_db: float = 2.5, deadline_slack=None,
                  load: float = 1.0, **kw) -> dict:
    """One replayable arrival trace: ``kind`` picks the arrival process
    (``poisson``/``bursty``/``replay``), every arrival draws its channel
    state from the seeded mMobile-like gain trace (``gain_offset_db`` =
    frame gain minus the trace mean, i.e. the fading excursion around
    the calibrated operating point), its budget and backbone from the
    given mixes, and its init seed from the arrival index. ``archs``
    accepts any request-registry name — CNN backbones and LM decoder
    configs mix freely in one trace (``MIXED_TRACE_ARCHS`` is the
    canonical CNN+LM blend).

    ``deadline_slack`` (optional ``(lo_s, hi_s)``) gives every arrival
    an absolute completion deadline ``deadline_s[i] = t[i] + slack_i``
    with per-request slack drawn uniformly from the range — the
    replayable input of the deadline-hit-rate benchmark (EDF admission
    + hopeless-lane shedding vs FIFO). The field JSON round-trips like
    every other column; traces without it decode to deadline-free
    requests.

    ``load`` scales the offered load: arrival times divide by it, so
    ``load=4.0`` is the same request mix arriving 4x faster (the
    overload-study knob — deadlines, drawn AFTER scaling, keep their
    absolute slack)."""
    if load <= 0:
        raise ValueError(f"load must be positive, got {load}")
    if kind == "poisson":
        t = poisson_arrivals(n, seed=seed, **kw)
    elif kind == "bursty":
        t = bursty_arrivals(n, seed=seed, **kw)
    elif kind == "replay":
        t = replay_arrivals(n, **kw)
    else:
        raise ValueError(f"unknown arrival kind {kind!r} "
                         f"(one of {ARRIVAL_KINDS})")
    t = t / load
    gains = synth_mmobile_trace(seed=seed, n_frames=max(n, 450),
                                fading_std_db=fading_std_db)
    rng = np.random.default_rng(seed + 1)
    out = dict(
        kind=kind, seed=seed, n=n, load=float(load),
        t=[float(v) for v in t],
        gain_offset_db=[float(gains[i % len(gains)] - gains.mean())
                        for i in range(n)],
        budget=[int(budgets[i]) for i in
                rng.integers(0, len(budgets), size=n)],
        arch=[str(archs[i]) for i in rng.integers(0, len(archs), size=n)],
        init_seed=list(range(n)),
    )
    if deadline_slack is not None:
        lo, hi = deadline_slack
        slack = rng.uniform(lo, hi, size=n)
        out["deadline_s"] = [float(ti + si)
                             for ti, si in zip(out["t"], slack)]
    return out


_PER_ARRIVAL_KEYS = ("t", "gain_offset_db", "budget", "arch", "init_seed",
                     "deadline_s")


def split_trace(trace: dict, n_hosts: int, seed: int = 0) -> list:
    """Deterministically split one arrival trace into ``n_hosts``
    per-host sub-traces (the fleet benchmark's ingest shards: each host
    replays its own sub-trace while the union is exactly the single-host
    workload). Every arrival is assigned to one host by a seeded draw;
    each sub-trace keeps its arrivals in global time order and records
    the original arrival indices in ``src_index``, so
    :func:`merge_traces` recomposes the original trace exactly and the
    per-request ``init_seed`` identity survives re-sharding. Sub-traces
    carry only JSON-native types and round-trip through
    :func:`save_trace`/:func:`load_trace`."""
    if n_hosts < 1:
        raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
    n = int(trace["n"])
    rng = np.random.default_rng(seed)
    host_of = rng.integers(0, n_hosts, size=n)
    subs = []
    for h in range(n_hosts):
        idx = [i for i in range(n) if host_of[i] == h]
        sub = {k: v for k, v in trace.items() if k not in _PER_ARRIVAL_KEYS}
        sub.update(
            n=len(idx), host=h, n_hosts=n_hosts, split_seed=int(seed),
            src_index=[int(i) for i in idx],
        )
        for k in _PER_ARRIVAL_KEYS:
            if k in trace:
                sub[k] = [trace[k][i] for i in idx]
        subs.append(sub)
    return subs


def merge_traces(subs: list) -> dict:
    """Inverse of :func:`split_trace`: recompose per-host sub-traces
    into the original trace (``merge_traces(split_trace(tr, k, s)) ==
    tr`` for any ``k``, ``s``). Raises if the sub-traces do not cover a
    contiguous ``0..n-1`` arrival-index range exactly once."""
    if not subs:
        raise ValueError("no sub-traces to merge")
    rows = []
    for sub in subs:
        for j, i in enumerate(sub["src_index"]):
            rows.append((int(i), sub, j))
    rows.sort()
    idxs = [r[0] for r in rows]
    if idxs != list(range(len(rows))):
        raise ValueError(
            f"sub-traces do not partition 0..n-1: got indices {idxs[:8]}...")
    out = {k: v for k, v in subs[0].items()
           if k not in _PER_ARRIVAL_KEYS
           and k not in ("host", "n_hosts", "split_seed", "src_index", "n")}
    out["n"] = len(rows)
    for k in _PER_ARRIVAL_KEYS:
        if k in subs[0]:
            out[k] = [sub[k][j] for _, sub, j in rows]
    return out


def save_trace(trace: dict, path: str) -> None:
    """Dump an arrival trace as JSON — the replay artifact a failing
    soak run uploads so the exact arrival sequence is reproducible."""
    import json
    import os
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(trace, f, sort_keys=True)


def load_trace(path: str) -> dict:
    import json
    with open(path) as f:
        return json.load(f)
