"""Torch analytic scenario surface — Eq. (1)-(4), penalty Eq. (11), and
the calibrated utility oracle (DESIGN.md §6). Counterpart of
``repro/core/jax_cost.py``.

Mirror of the numpy ``CostModel``/``SplitInferenceProblem`` math with the
per-layer profile precomputed into float32 device tensors, so the penalty
can be evaluated inside the acquisition (grid scoring and the refinement
loop) with no host round-trip. Non-finite penalties (deep-fade frames
where the achievable rate underflows) are capped at ``PENALTY_CAP`` to
keep gradients usable, matching ``SplitInferenceProblem.penalty_batch``.

A scenario's parameters are a flat dict of tensors. S scenarios stack
into one dict whose leaves carry a leading ``(S,)`` axis
(:func:`stack_params`), which stands in for the reference's ``vmap``:
every function here takes params with batch shape ``B`` (empty for one
scenario, ``(S,)`` for a stack) and points ``a`` of shape
``(*B, *P, 2)``, where ``P`` is zero or more point axes. Scenarios of
different architectures stack too: per-layer arrays are padded to a
batch-wide ``L_max`` (edge values, plus a ``layer_mask`` marking the real
splits) while ``n_layers`` stays each scenario's true ``L``.

Two reference behaviours kept on purpose:

* ``torch.round`` rounds half to even, like ``jnp.rint``/``jnp.round``.
* JAX indexing wraps a negative index and clamps one out of range; a
  CUDA gather asserts. Every per-layer gather goes through :func:`_take`,
  which does the same first.
"""
from __future__ import annotations

import numpy as np
import torch

PENALTY_CAP = 1e6
F32 = torch.float32


def make_params(problem, l_pad: int | None = None, device="cuda") -> dict:
    """Precompute per-layer profile tensors for a ``SplitInferenceProblem``.

    Index ``l`` (1..L) into the ``(L+1,)`` arrays is the split layer;
    index 0 is the (unused) transmit-raw-input split. ``l_pad`` pads the
    per-layer arrays to a batch-wide ``(l_pad+1,)`` max-L layout (edge
    values; ``layer_mask`` stays False in the tail). Host values are
    float64 numpy; every float leaf is cast to float32 on ``device``, as
    the reference casts to f32.
    """
    from repro_torch.core.cost_model import CostModel, pad_profile

    cm = problem.cm
    prof = cm.profile
    if l_pad is None:
        l_pad = prof.n_layers
    prof_p, valid = pad_profile(prof, l_pad)
    if prof_p is not prof:
        cm = CostModel(prof_p, cm.device, cm.server, cm.link, cm.budgets)
    ls = np.arange(l_pad + 1)
    gain_lin = 10.0 ** (problem.gain_db / 10.0)
    u = problem.util

    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float64)).to(device, F32)

    return dict(
        layer_mask=torch.as_tensor((ls >= 1) & valid).to(device),
        # utility-oracle calibration (ignored by penalty/energy_delay)
        base_acc=f32(u.base_acc),
        bump=f32(u.bump),
        peak_layer=f32(u.peak_layer),
        sigma_u=f32(u.sigma),
        eps_energy=f32(u.eps_energy),
        quantum=f32(u.quantum),
        completion_floor=f32(u.completion_floor),
        dev_energy=f32(cm.device_energy_j(ls)),
        dev_delay=f32(cm.device_delay_s(ls)),
        srv_delay=f32(cm.server_delay_s(ls)),
        tx_bits=f32(cm.tx_bits(ls)),
        gain_lin=f32(gain_lin),
        noise_w=f32(cm.link.noise_power_w),
        bandwidth_hz=f32(cm.link.bandwidth_hz),
        e_max=f32(cm.budgets.e_max_j),
        tau_max=f32(cm.budgets.tau_max_s),
        p_min=f32(problem.p_min),
        p_max=f32(problem.p_max),
        n_layers=f32(prof.n_layers),
    )


def pad_params(params: dict, l_pad: int) -> dict:
    """Pad ONE scenario's param dict to a ``(l_pad+1,)`` per-layer layout:
    a one-row :func:`stack_params`, identical to
    ``make_params(problem, l_pad)``."""
    return {k: v[0] for k, v in stack_params([params], l_pad=l_pad).items()}


def stack_params(params_list, l_pad: int | None = None) -> dict:
    """Stack per-scenario param dicts into one batched dict (S, ...).

    Per-layer arrays shorter than the batch-wide ``L_max`` (or the forced
    ``l_pad``) are padded on the fly: edge values for the cost surfaces,
    False for ``layer_mask``. Each scenario's ``n_layers`` stays its true
    ``L``, which keeps the padded tail unreachable."""
    out = {}
    for k in params_list[0].keys():
        vals = [p[k] for p in params_list]
        if vals[0].ndim:
            n = max(v.shape[0] for v in vals)
            if l_pad is not None:
                if l_pad + 1 < n:
                    raise ValueError(
                        f"l_pad={l_pad} below stacked L_max={n - 1}")
                n = l_pad + 1
            vals = [v if v.shape[0] == n else _pad_tail(v, n, k)
                    for v in vals]
        out[k] = torch.stack(vals)
    return out


def _pad_tail(v, n: int, key: str):
    if key == "layer_mask":                         # False tail
        return torch.cat([v, v.new_zeros(n - v.shape[0])])
    return torch.cat([v, v[-1:].expand(n - v.shape[0])])   # edge tail


def _bcast(v, x):
    """A per-scenario value of batch shape ``B`` viewed to broadcast
    against ``x`` of shape ``(*B, *P)``."""
    return v.reshape(v.shape + (1,) * (x.ndim - v.ndim))


def _take(arr, li):
    """``arr[..., li]`` per scenario: ``arr (*B, L+1)``, ``li (*B, *P)``.
    As JAX indexing does, a negative index counts from the end and the
    result is clipped into range before the gather."""
    nb = arr.ndim - 1
    n = arr.shape[-1]
    idx = li.long()
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    flat = idx.reshape(idx.shape[:nb] + (-1,))
    return torch.gather(arr, -1, flat).reshape(idx.shape)


def valid_split(params, li):
    """True iff ``li`` is a real (non-padded) split layer:
    ``1 <= li <= n_layers``."""
    return (li >= 1) & (li <= _bcast(params["n_layers"].int(), li))


def denormalize(params, a):
    """a: (*B, *P, 2) normalized -> (layer index int64, power watts)."""
    a = a.clamp(0.0, 1.0)
    a0, a1 = a[..., 0], a[..., 1]
    p_min, p_max = _bcast(params["p_min"], a0), _bcast(params["p_max"], a0)
    n_layers = _bcast(params["n_layers"], a1)
    p = p_min + a0 * (p_max - p_min)
    lf = torch.round(1.0 + a1 * (n_layers - 1.0))
    li = torch.minimum(lf.clamp(min=1.0), n_layers).long()
    return li, p


def energy_delay(params, li, p):
    """Total energy (J) and delay (s) at split-layer index li, power p."""
    snr = p * _bcast(params["gain_lin"], p) / _bcast(params["noise_w"], p)
    rate = _bcast(params["bandwidth_hz"], p) * torch.log2(1.0 + snr)
    bits = _take(params["tx_bits"], li)
    tx_delay = bits / rate.clamp(min=1e-30)
    e = _take(params["dev_energy"], li) + p * tx_delay
    t = (_take(params["dev_delay"], li) + tx_delay
         + _take(params["srv_delay"], li))
    return e, t


def penalty(params, a):
    """Eq. (11): ReLU'd budget violations, capped (inf-safe)."""
    li, p = denormalize(params, a)
    e, t = energy_delay(params, li, p)
    pen = ((e - _bcast(params["e_max"], e)).clamp(min=0.0)
           + (t - _bcast(params["tau_max"], t)).clamp(min=0.0))
    pen = torch.where(torch.isnan(pen), PENALTY_CAP, pen)
    return pen.clamp(max=PENALTY_CAP)


def normalize(params, li, p):
    """Inverse of :func:`denormalize`: (layer index, power W) -> a in
    [0,1]^2 (same layout as ``SplitInferenceProblem.normalize``)."""
    p_min, p_max = _bcast(params["p_min"], p), _bcast(params["p_max"], p)
    a0 = (p - p_min) / (p_max - p_min)
    a1 = (li.to(F32) - 1.0) / (_bcast(params["n_layers"], li) - 1.0)
    return torch.stack(torch.broadcast_tensors(a0, a1), dim=-1)


def seen_key(p):
    """``round(p_w, 3)`` — the eval-ledger dedupe key for discrete probes
    (``torch.round`` matches Python's round-half-to-even)."""
    return torch.round(p * 1000.0) / 1000.0


def quantize_key(x, quantum: float) -> float:
    """Host mirror of :func:`seen_key`'s half-to-even quantization for an
    arbitrary quantum (``np.round`` is half-to-even)."""
    return float(np.round(np.float64(x) / quantum) * quantum)


def utility(params, li, p):
    """The calibrated deterministic oracle (DESIGN.md §6), device-side.

    Mirror of ``SplitInferenceProblem._accuracy`` + the feasibility bit:
    returns ``(smooth utility, quantized reported accuracy, feasible)``.
    """
    def q(k):
        return _bcast(params[k], p)

    e, t = energy_delay(params, li, p)
    phi = (q("tau_max") / t.clamp(min=1e-9)).clamp(max=1.0)
    # deadline truncation: tail skipped, base accuracy retained
    trunc = q("base_acc") * (phi / q("completion_floor")).clamp(max=1.0)
    acc_trunc = torch.floor(trunc / q("quantum") + 1e-9) * q("quantum")
    # full completion: feature-robustness bump + energy tie-break
    bump = q("bump") * torch.exp(
        -0.5 * torch.square((li.to(F32) - q("peak_layer")) / q("sigma_u")))
    raw = q("base_acc") + bump
    full_smooth = raw - q("eps_energy") * e / q("e_max")
    acc_full = torch.floor(raw / q("quantum") + 1e-9) * q("quantum")
    full = phi >= 1.0
    smooth = torch.where(full, full_smooth, trunc)
    acc = torch.where(full, acc_full, acc_trunc)
    dead = (e > q("e_max")) | (phi < q("completion_floor"))
    feas = (e <= q("e_max")) & (t <= q("tau_max"))
    zero = torch.zeros_like(smooth)
    return (torch.where(dead, zero, smooth), torch.where(dead, zero, acc),
            feas)


def project_feasible(params, a, margin: float = 1.02):
    """Lift the power coordinate to the analytic min-feasible power for
    the point's layer (identity if already feasible, or if no feasible
    power exists for that layer) — ``SplitInferenceProblem
    .project_feasible`` on device."""
    li, p = denormalize(params, a)

    def q(k):
        return _bcast(params[k], p)

    e, t = energy_delay(params, li, p)
    feas = (e <= q("e_max")) & (t <= q("tau_max"))
    slack = (q("tau_max") - _take(params["dev_delay"], li)
             - _take(params["srv_delay"], li))
    rate_needed = _take(params["tx_bits"], li) / slack.clamp(min=1e-30)
    x = 2.0 ** (rate_needed / q("bandwidth_hz")) - 1.0
    p_req = x * q("noise_w") / q("gain_lin") * margin
    cand = normalize(params, li, torch.maximum(p, p_req))
    lc, pc = denormalize(params, cand)
    ec, tc = energy_delay(params, lc, pc)
    cand_ok = ((slack > 0.0) & (p_req <= q("p_max"))
               & (ec <= q("e_max")) & (tc <= q("tau_max")))
    return torch.where((~feas & cand_ok)[..., None], cand, a)


def fallback_answer(params, best_a, has_best):
    """Best-effort answer for a lane retired before convergence: the
    incumbent if one exists, else the feasible projection of the
    search-space center. Returns ``(a, u, feas)``."""
    center = torch.full_like(best_a, 0.5)
    proj = project_feasible(params, center)
    a = torch.where(_bcast(torch.as_tensor(has_best, device=best_a.device),
                           best_a), best_a, proj)
    li, p = denormalize(params, a)
    u, _, feas = utility(params, li, p)
    return a, u, feas
