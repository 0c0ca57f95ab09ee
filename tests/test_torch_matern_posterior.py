"""The plain ``matern_posterior`` (what ``ops.matern_posterior`` returns
for CPU tensors, and what the CUDA posterior kernel is held against on
the card) against the reference's ``gp.posterior_with_grad_batch``,
vmapped over scenarios, on GPs the reference fitted and
``interop.from_reference`` carried across: n 16/32/48/64, a ragged N
(203), lanes with masked points, a lane whose Cholesky failed and
candidates on training points.

Tolerances: mu and dmu rtol 1e-5 and atol 1e-6 plus 1e-6 of the sum of
the magnitudes of their terms (both sides sum n float32 terms in another
order, and a fitted GP's alpha makes the terms far larger than their
sum); sigma^2 within 1e-5 sv y_sigma^2 (the cancellation in
sv - |L^-1 ks|^2). The mean also equals the reference's Pallas
``matern_score`` in interpret mode, on the raw scale, within the same
bar, and ``acquisition.block_posterior`` on the CPU is the plain version
bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gp as ref_gp
from repro.kernels.matern_score.ops import matern_score as ref_kernel
from repro_torch.core import acquisition as port_acq
from repro_torch.core import gp as port_gp
from repro_torch.interop import from_reference
from repro_torch.kernels.matern_score import (matern_posterior,
                                              matern_posterior_ref)
from repro_torch.kernels.matern_score.ops import instance

torch.set_num_threads(1)
S, N_RAGGED = 3, 203
RTOL, ATOL, TERMS = 1e-5, 1e-6, 1e-6
SQRT5 = np.sqrt(5.0)
_FITS = {}


def _fitted(n):
    """A reference GP fitted on n points a lane (lane 1 with 3 masked,
    lane 2 with half masked), as (reference cache, port cache), and the
    candidates: a ragged N, two of them on training points."""
    if n not in _FITS:
        rng = np.random.default_rng(n)
        x = rng.random((S, n, 2)).astype(np.float32)
        y = (80.0 + 5.0 * np.sin(4 * x[..., 0]) + 3.0 * x[..., 1]
             + 0.1 * rng.standard_normal((S, n))).astype(np.float32)
        mask = np.arange(n)[None] < np.array([n, n - 3, n // 2])[:, None]
        data = dict(x=np.where(mask[..., None], x, 0).astype(np.float32),
                    y=np.where(mask, y, 0).astype(np.float32), mask=mask)
        cache_r = ref_gp.fit_batch({k: jnp.asarray(v) for k, v in
                                    data.items()}, ref_gp.GPConfig())
        cache_r = jax.tree.map(np.asarray, cache_r)
        cand = rng.random((S, N_RAGGED, 2)).astype(np.float32)
        cand[0, 0] = data["x"][0, 0]
        cand[1, 5] = data["x"][1, 2]
        _FITS[n] = cache_r, cand
    return _FITS[n]


def _args(cache_p, cand):
    th = cache_p["theta"]
    return (torch.as_tensor(cand), cache_p["x"], cache_p["alpha"],
            cache_p["mask"].float(), cache_p["L"], torch.exp(th["log_ls"]),
            torch.exp(th["log_sv"]), cache_p["y_mu"], cache_p["y_sigma"])


def _terms(cand, x, alpha, mask, ls, sv, ys):
    """Per candidate, the sums of the magnitudes of the terms of mu
    (S, N) and of each component of dmu (S, N, 2), raw scale."""
    c, xs = np.float64(cand), np.float64(x)
    ls3, sv3 = np.float64(ls)[:, None, None], np.float64(sv)[:, None, None]
    diff = xs[:, :, None, :] - c[:, None, :, :]
    r = np.sqrt(np.maximum((diff ** 2).sum(-1), 1e-16)) / ls3
    e = np.exp(-SQRT5 * r)
    w = np.abs(np.float64(alpha) * mask)[:, :, None]
    t_mu = np.float64(ys)[:, None] * (w * sv3 * (1 + SQRT5 * r
                                                 + 5 * r * r / 3) * e).sum(1)
    g = w * (5 / 3) * sv3 * (1 + SQRT5 * r) * e / ls3 ** 2
    t_dmu = (np.float64(ys)[:, None, None]
             * (g[..., None] * np.abs(diff)).sum(1))
    return t_mu, t_dmu


def _assert_close(got, want, args):
    """mu and dmu within RTOL, ATOL + TERMS x their terms; sigma^2 within
    1e-5 sv y_sigma^2; NaN in the same places."""
    cand, x, alpha, mask, _, ls, sv, _, ys = (
        a.numpy() if torch.is_tensor(a) else a for a in args)
    t_mu, t_dmu = _terms(cand, x, alpha, mask, ls, sv, ys)
    mu, sigma, dmu = (t.numpy() for t in got)
    mu_w, sigma_w, dmu_w = (np.asarray(t) for t in want)
    for a, b in ((mu, mu_w), (sigma, sigma_w), (dmu, dmu_w)):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    for a, b, t in ((mu, mu_w, t_mu), (dmu, dmu_w, t_dmu)):
        live = np.isfinite(b)
        assert np.all(np.abs(a - b)[live] <= (RTOL * np.abs(b) + ATOL
                                              + TERMS * t)[live])
    live = np.isfinite(sigma_w)
    var_err = (np.abs(np.float64(sigma) ** 2 - np.float64(sigma_w) ** 2)
               / (np.float64(sv) * np.float64(ys) ** 2)[:, None])
    assert np.all(var_err[live] <= 1e-5)


def _reference(cache_r, cand):
    return jax.vmap(ref_gp.posterior_with_grad_batch)(cache_r,
                                                      jnp.asarray(cand))


@pytest.mark.parametrize("n", [16, 32, 48, 64])
def test_plain_posterior_matches_reference(n):
    cache_r, cand = _fitted(n)
    args = _args(from_reference(cache_r, "cpu"), cand)
    got = matern_posterior(*args)
    assert [tuple(t.shape) for t in got] == [(S, N_RAGGED), (S, N_RAGGED),
                                             (S, N_RAGGED, 2)]
    assert all(t.dtype == torch.float32 for t in got)
    # candidates on training points stay finite
    assert all(bool(torch.isfinite(t).all()) for t in got)
    _assert_close(got, _reference(cache_r, cand), args)


def test_failed_cholesky_lane_is_nan_where_the_reference_is():
    """Lane 1's factor is JAX's Cholesky of an indefinite matrix (NaN),
    then the port's (NaN on and below the diagonal): NaN in the same
    places as the reference's; the other lanes unchanged."""
    cache_r, cand = _fitted(16)
    bad = -np.eye(16, dtype=np.float32)
    L = cache_r["L"].copy()
    L[1] = np.asarray(jnp.linalg.cholesky(jnp.asarray(bad)))
    cache_r = dict(cache_r, L=L)
    want = _reference(cache_r, cand)
    assert np.isnan(np.asarray(want[1])[1]).all()
    cache_p = from_reference(cache_r, "cpu")
    args = _args(cache_p, cand)
    _assert_close(matern_posterior(*args), want, args)
    cache_p["L"][1] = port_gp.cholesky(torch.as_tensor(bad))
    args = _args(cache_p, cand)
    _assert_close(matern_posterior(*args), want, args)


@pytest.mark.parametrize("n", [16, 64])
def test_mean_equals_the_reference_kernel_in_interpret_mode(n):
    cache_r, cand = _fitted(n)
    args = _args(from_reference(cache_r, "cpu"), cand)
    mu_std = np.asarray(ref_kernel(
        *(jnp.asarray(a.numpy() if torch.is_tensor(a) else a)
          for a in (args[0], *args[1:4], *args[5:7])),
        block_n=128, interpret=True, use_ref=False))
    ys, ym = cache_r["y_sigma"], cache_r["y_mu"]
    mu = matern_posterior(*args)[0].numpy()
    t_mu, _ = _terms(*(a.numpy() for a in (*args[:4], *args[5:7])), ys)
    assert np.all(np.abs(mu - (mu_std * ys[:, None] + ym[:, None]))
                  <= RTOL * np.abs(mu) + ATOL + TERMS * t_mu)


def test_block_posterior_is_the_plain_version():
    cache_r, cand = _fitted(32)
    cache_p = from_reference(cache_r, "cpu")
    got = port_acq.block_posterior(cache_p, torch.as_tensor(cand))
    want = matern_posterior_ref(*_args(cache_p, cand))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("n", [5, 20, 37])
def test_padding_to_the_instance_is_exact(n):
    """The kernel pads n points to its instance in shared memory: x, w
    and mask 0, L with identity rows. The padded problem has the same
    posterior."""
    cache_r, cand = _fitted(n)
    args = _args(from_reference(cache_r, "cpu"), cand)
    cand_t, x, alpha, mask, L, ls, sv, ym, ys = args
    m = instance(n)
    pad = (0, m - n)
    Lp = torch.eye(m).repeat(S, 1, 1)
    Lp[:, :n, :n] = L
    padded = (cand_t, torch.nn.functional.pad(x, (0, 0) + pad),
              torch.nn.functional.pad(alpha, pad),
              torch.nn.functional.pad(mask, pad), Lp, ls, sv, ym, ys)
    _assert_close(matern_posterior(*padded), matern_posterior(*args), args)


@pytest.mark.parametrize("case", ["n_past_64", "d_not_2", "L_shape",
                                  "cand_not_8_byte_aligned"])
def test_posterior_raises_on_what_the_kernel_does_not_take(case):
    """Each raises a ValueError before any launch; a misaligned cand is a
    contiguous view 4 bytes into its storage, which the kernel's float2
    read would fault on."""
    n = 65 if case == "n_past_64" else 4
    d = 3 if case == "d_not_2" else 2
    t = torch.zeros
    cand = t(1, 7, d)
    if case == "cand_not_8_byte_aligned":
        cand = t(1 + 7 * d)[1:].view(1, 7, d)
        assert cand.is_contiguous() and cand.data_ptr() % 8 == 4
    args = dict(cand=cand, x=t(1, n, d), alpha=t(1, n), mask=t(1, n),
                L=t(1, n, n - 1 if case == "L_shape" else n), ls=t(1),
                sv=t(1), y_mu=t(1), y_sigma=t(1))
    with pytest.raises(ValueError):
        matern_posterior(**args)
