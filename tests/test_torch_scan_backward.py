"""The recurrent scans' backwards on the CPU: the plain reverse loops
(``rglru_scan_bwd_ref``, ``rwkv6_scan_bwd_ref``) against ``jax.vjp`` of
the reference's scans and against ``torch.autograd`` of the port's plain
forwards; the plain emulations of the backward kernels' order against
the plain loops; the ``torch.autograd.Function``s (``RGLRUScan``,
``RWKV6Scan``, which dispatch to the plain versions on CPU tensors)
against autograd of the plain forwards; and a reduced RecurrentGemma-2B
and RWKV6-3B whose scans go through the Functions against the default
CPU route. Inputs come from numpy seeds, at S <= 64, R <= 48, hd <= 32,
and for the RWKV6 row kernel's other instances hd 64 and 256 at S 9 and
hd 160 (RWKV6-3B's) at S 8 and 11.

Tolerances, each of a tensor's largest magnitude: ``VJP_TOL`` 1e-5 for
a plain backward against ``jax.vjp`` or autograd (float32 sums in
another order; the RG-LRU's loop is the same products as autograd's,
the reference's associative scan associates them otherwise, and the
wkv loop's einsums sum rows in another order); ``EMU_TOL`` 1e-5 for an
emulation against its plain loop (the kernels' summation order, fused
multiply-adds taken unfused in the RWKV6 emulation); ``GRAD_RTOL`` 1e-4
plus 1e-7 for a model's gradient leaves (``tests/test_torch_train.py``'s
bar: through a whole model and its cross-entropy)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_rglru_ref
from repro.kernels.rwkv6_scan.ref import rwkv6_scan_ref as jax_rwkv6_ref
from repro.models.rwkv6 import _wkv_scan
from repro_torch.configs import get_config, reduced
from repro_torch.data import SyntheticTokenPipeline
from repro_torch.kernels.rglru_scan import (RGLRUScan, rglru_scan_bwd,
                                            rglru_scan_bwd_chunked_ref,
                                            rglru_scan_bwd_ref,
                                            rglru_scan_ref)
from repro_torch.kernels.rwkv6_scan import (RWKV6Scan, rwkv6_checkpoints_ref,
                                            rwkv6_scan_bwd,
                                            rwkv6_scan_bwd_ref,
                                            rwkv6_scan_bwd_tiled_ref,
                                            rwkv6_scan_fwd, rwkv6_scan_ref)
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv6 as rwkv6_mod
from repro_torch.models import transformer as tfm
from repro_torch.train import trainer

torch.set_num_threads(1)
VJP_TOL = 1e-5
EMU_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7

# (B, S, R): the reference's kernel cases, a one-chunk S and a ragged
# piece
RGLRU_CASES = [(2, 64, 32), (1, 50, 48), (2, 5, 16), (1, 1, 8)]
# (B, S, H, hd, underflow): the reference's kernel cases, a ragged hd
# and a partial checkpoint span, the row kernel's instances of widths
# 64 and 256 with a last span of one step, and of width 160 (RWKV6-3B's
# head dim) with one whole span; ``underflow`` puts
# logw at -2981 (w = exp(-exp(8)), 0 in float32) on every other step
RWKV_CASES = [(2, 64, 2, 16, False), (1, 37, 3, 20, False),
              (1, 19, 2, 32, True), (1, 9, 1, 64, False),
              (1, 9, 1, 256, False), (1, 8, 1, 160, False)]


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _rglru_inputs(B, S, R, seed=0):
    rng = np.random.default_rng(seed)
    a = 1 / (1 + np.exp(-rng.standard_normal((B, S, R))))
    b, dhs = (rng.standard_normal((B, S, R)) for _ in range(2))
    h0, dh_last = (rng.standard_normal((B, R)) for _ in range(2))
    return [x.astype(np.float32) for x in (a, b, h0, dhs, dh_last)]


def _rwkv_inputs(B, S, H, hd, underflow, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v, do = (rng.standard_normal((B, S, H, hd)) for _ in range(4))
    logw = -np.exp(rng.standard_normal((B, S, H, hd))) * 0.5
    if underflow:
        logw[:, ::2] = -np.exp(8.0)
    u = rng.standard_normal((H, hd)) * 0.1
    s0, ds_last = (rng.standard_normal((B, H, hd, hd)) * 0.1
                   for _ in range(2))
    return [x.astype(np.float32) for x in (r, k, v, logw, u, s0, do,
                                           ds_last)]


def _t(xs):
    return [torch.as_tensor(x) for x in xs]


@pytest.mark.parametrize("case", RGLRU_CASES)
def test_rglru_bwd_ref_matches_reference_vjp(case):
    a, b, h0, dhs, dh_last = _rglru_inputs(*case)

    def vjp(*xs):
        _, back = jax.vjp(jax_rglru_ref, *xs[:3])
        return back(xs[3:])

    args = tuple(jnp.asarray(x) for x in (a, b, h0, dhs, dh_last))
    # compiled without XLA's costly passes: the eager associative scan
    # dispatches op by op (seconds a case)
    want = jax.jit(vjp).lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})(*args)
    ta, _, th0, tdhs, tdl = _t((a, b, h0, dhs, dh_last))
    ths, _ = rglru_scan_ref(ta, torch.as_tensor(b), th0)
    got = rglru_scan_bwd_ref(ta, th0, ths, tdhs, tdl)
    for name, g, w in zip(("da", "db", "dh0"), got, want):
        _close(g, w, VJP_TOL, f"rglru {case} {name}")


@pytest.mark.parametrize("case", RGLRU_CASES)
@pytest.mark.parametrize("with_last", [True, False])
def test_rglru_bwd_ref_autograd_and_emulation(case, with_last):
    """The plain loop equals autograd of the plain forward; the kernel's
    chunked order agrees with it; the Function on CPU tensors, with no
    cotangent for h_last, equals autograd of the plain forward."""
    a, b, h0, dhs, dh_last = _t(_rglru_inputs(*case, seed=1))
    dh_last = dh_last if with_last else None
    leaves = [t.clone().requires_grad_(True) for t in (a, b, h0)]
    hs, h_last = rglru_scan_ref(*leaves)
    out = (hs * dhs).sum() + ((h_last * dh_last).sum() if with_last else 0)
    want = torch.autograd.grad(out, leaves)
    got = rglru_scan_bwd_ref(a, h0, hs.detach(), dhs, dh_last)
    emu = rglru_scan_bwd_chunked_ref(a, h0, hs.detach(), dhs, dh_last)
    wrapped = rglru_scan_bwd(a, h0, hs.detach(), dhs, dh_last)
    for name, g, w, e, x in zip(("da", "db", "dh0"), got, want, emu,
                                wrapped):
        _close(g, w, VJP_TOL, f"rglru autograd {case} {name}")
        _close(e, g, EMU_TOL, f"rglru emulation {case} {name}")
        assert torch.equal(x, g)
    if not with_last:
        fn_leaves = [t.clone().requires_grad_(True) for t in (a, b, h0)]
        hs_fn, _ = RGLRUScan.apply(*fn_leaves)
        assert torch.equal(hs_fn, hs.detach())
        hs_fn.backward(dhs)
        for leaf, w in zip(fn_leaves, want):
            _close(leaf.grad, w, VJP_TOL, f"RGLRUScan {case}")


@pytest.mark.parametrize("chunks", [1, 2, 3, 16])
def test_rglru_bwd_emulation_other_chunkings(chunks):
    """The emulation's carry across chunks and pieces at chunkings the
    plan does not pick (3 chunks leave a ragged piece)."""
    a, b, h0, dhs, dh_last = _t(_rglru_inputs(1, 37, 12, seed=2))
    hs, _ = rglru_scan_ref(a, b, h0)
    want = rglru_scan_bwd_ref(a, h0, hs, dhs, dh_last)
    got = rglru_scan_bwd_chunked_ref(a, h0, hs, dhs, dh_last, chunks=chunks,
                                     chunk=4)
    for g, w in zip(got, want):
        _close(g, w, EMU_TOL, f"rglru emulation chunks={chunks}")


@pytest.mark.parametrize("case", RWKV_CASES)
@pytest.mark.parametrize("oracle", ["wkv_scan", "kernel_ref"])
def test_rwkv6_bwd_ref_matches_reference_vjp(case, oracle):
    """Against ``jax.vjp`` of the model's ``_wkv_scan`` and of the
    kernel's oracle ``rwkv6_scan_ref``, s0 and ds_last nonzero."""
    r, k, v, logw, u, s0, do, ds_last = _rwkv_inputs(*case)
    fn = _wkv_scan if oracle == "wkv_scan" else jax_rwkv6_ref
    _, vjp = jax.vjp(fn, r, k, v, logw, u, s0)
    want = vjp((jnp.asarray(do), jnp.asarray(ds_last)))
    got = rwkv6_scan_bwd_ref(*_t((r, k, v, logw, u, s0, do, ds_last)))
    for name, g, w in zip(("dr", "dk", "dv", "dlogw", "du", "ds0"), got,
                          want):
        _close(g, w, VJP_TOL, f"rwkv6 {oracle} {case} {name}")


@pytest.mark.parametrize("case", RWKV_CASES)
def test_rwkv6_bwd_ref_autograd_emulation_and_function(case):
    """The plain loop equals autograd of the plain forward; the kernels'
    order (``rwkv6_scan_bwd_tiled_ref``) agrees with it; the
    checkpoints are the plain forward's states; the Function on CPU
    tensors, with no cotangent for s_last, equals autograd."""
    r, k, v, logw, u, s0, do, ds_last = _t(_rwkv_inputs(*case, seed=1))
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, logw, u,
                                                       s0)]
    o, s_last = rwkv6_scan_ref(*leaves)
    want = torch.autograd.grad((o * do).sum() + (s_last * ds_last).sum(),
                               leaves, retain_graph=True)
    got = rwkv6_scan_bwd_ref(r, k, v, logw, u, s0, do, ds_last)
    emu = rwkv6_scan_bwd_tiled_ref(r, k, v, logw, u, s0, do, ds_last)
    for name, g, w, e in zip(("dr", "dk", "dv", "dlogw", "du", "ds0"), got,
                             want, emu):
        _close(g, w, VJP_TOL, f"rwkv6 autograd {case} {name}")
        _close(e, g, EMU_TOL, f"rwkv6 emulation {case} {name}")
    o_fwd, s_fwd, ckpt = rwkv6_scan_fwd(r, k, v, logw, u, s0)
    assert torch.equal(o_fwd, o.detach()) and torch.equal(s_fwd,
                                                          s_last.detach())
    assert ckpt.shape[1] == -(-r.shape[1] // 8)
    assert torch.equal(ckpt, rwkv6_checkpoints_ref(r, k, v, logw, u, s0))
    assert torch.equal(ckpt[:, 0], s0)
    for g, x in zip(got, rwkv6_scan_bwd(r, k, v, logw, u, s0, ckpt, do,
                                        ds_last)):
        assert torch.equal(x, g)
    fn_leaves = [t.clone().requires_grad_(True) for t in (r, k, v, logw, u,
                                                          s0)]
    o_fn, _ = RWKV6Scan.apply(*fn_leaves)
    o_fn.backward(do)
    no_last = torch.autograd.grad((o * do).sum(), leaves)
    for leaf, w in zip(fn_leaves, no_last):
        _close(leaf.grad, w, VJP_TOL, f"RWKV6Scan {case}")


@pytest.mark.parametrize("last", [True, False])
def test_rwkv6_bwd_emulation_at_the_training_width(last):
    """The emulation at hd 160, RWKV6-3B's head dim, whose instance (10
    columns a lane) no case of ``RWKV_CASES`` reaches, agrees with the
    plain loop, with and without a last-state cotangent."""
    r, k, v, logw, u, s0, do, ds_last = _t(_rwkv_inputs(1, 11, 1, 160,
                                                        False, seed=2))
    ds_last = ds_last if last else None
    want = rwkv6_scan_bwd_ref(r, k, v, logw, u, s0, do, ds_last)
    got = rwkv6_scan_bwd_tiled_ref(r, k, v, logw, u, s0, do, ds_last)
    for name, g, w in zip(("dr", "dk", "dv", "dlogw", "du", "ds0"), got,
                          want):
        _close(g, w, EMU_TOL, f"rwkv6 emulation, hd 160, {name}")


def _through_functions(monkeypatch):
    """Route the models' scans through the autograd Functions."""
    monkeypatch.setattr(rglru_mod, "rglru_scan",
                        lambda a, b, h0, h_out=None: RGLRUScan.apply(a, b, h0))
    monkeypatch.setattr(rwkv6_mod, "rwkv6_scan",
                        lambda r, k, v, logw, u, s0, s_out=None:
                        RWKV6Scan.apply(r, k, v, logw, u, s0))


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-3b"])
def test_model_grads_through_the_functions(arch, monkeypatch):
    """A reduced float32 model's loss and gradients with its scans
    through the Functions (the plain backward loops) equal the default
    CPU route's (autograd through the plain forwards)."""
    cfg = dataclasses.replace(reduced(get_config(arch)), n_layers=3)
    model = tfm.init_model(cfg, torch.Generator().manual_seed(1), "cpu")
    toks = SyntheticTokenPipeline(cfg.vocab_size, 2, 16, seed=3
                                  ).batch_at(0)["tokens"]
    batch = dict(tokens=torch.as_tensor(toks))
    (want_loss, _), want = trainer.value_and_grad(model, batch, cfg)
    _through_functions(monkeypatch)
    (loss, _), got = trainer.value_and_grad(model, batch, cfg)
    assert abs(float(loss) - float(want_loss)) <= 1e-6 * abs(float(want_loss))
    assert sorted(got) == sorted(want)
    for name in want:
        w = want[name].numpy()
        np.testing.assert_allclose(
            got[name].numpy(), w, rtol=0,
            atol=GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL,
            err_msg=f"{arch} {name}")
