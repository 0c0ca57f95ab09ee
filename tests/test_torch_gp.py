"""The port's GP (``repro_torch.core.gp``) against ``repro.core.gp`` on
the same numpy-seeded data. Tolerances: kernel values and one Adam step
rtol 1e-6; the MLL and its gradient rtol 1e-5; fitted hyperparameters
after 150 Adam steps rtol 1e-4 (autodiff orders differ); posteriors
given the same fitted cache rtol 1e-5 for the mean and its gradient;
sigma, where sv - |L^-1 k|^2 cancels in float32, held in both packages
to a float64 evaluation of the same posterior within the cancellation's
bound (``_sigma64``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gp as ref
from repro_torch.core import gp as port
from repro_torch.interop import from_reference

torch.set_num_threads(1)
CFG_R, CFG_P = ref.GPConfig(), port.GPConfig()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(S=3, m=16, seed=0):
    """A bucketed dataset batch: lane s has 6 + 3 s active points."""
    rng = np.random.default_rng(seed)
    x = rng.random((S, m, 2)).astype(np.float32)
    y = (80.0 + 5.0 * np.sin(4 * x[..., 0]) + 3.0 * x[..., 1]
         + 0.1 * rng.standard_normal((S, m))).astype(np.float32)
    mask = np.arange(m)[None, :] < (6 + 3 * np.arange(S))[:, None]
    x = np.where(mask[..., None], x, 0.0).astype(np.float32)
    y = np.where(mask, y, 0.0).astype(np.float32)
    return dict(x=x, y=y, mask=mask)


def _both(data):
    return ({k: jnp.asarray(v) for k, v in data.items()},
            from_reference(data, "cpu"))


def _theta(S, seed=1):
    rng = np.random.default_rng(seed)
    return dict(log_ls=np.log(0.1 + 0.5 * rng.random(S)).astype(np.float32),
                log_sv=(0.3 * rng.standard_normal(S)).astype(np.float32),
                log_nv=np.log(1e-3 + 1e-2 * rng.random(S)).astype(
                    np.float32))


def test_matern52_equal():
    rng = np.random.default_rng(0)
    a, b = rng.random((7, 2)), rng.random((5, 2))
    r = np.asarray(ref.matern52(jnp.asarray(a, jnp.float32),
                                jnp.asarray(b, jnp.float32), 0.3, 1.7))
    p = port.matern52(torch.as_tensor(a, dtype=torch.float32),
                      torch.as_tensor(b, dtype=torch.float32), 0.3, 1.7)
    np.testing.assert_allclose(p.numpy(), r, rtol=1e-6)
    # identical points hit the distance floor without NaN
    same = port.matern52(torch.zeros(2, 2), torch.zeros(3, 2), 0.3, 1.0)
    assert torch.all(torch.isfinite(same))


@pytest.mark.parametrize("with_prior", [False, True])
def test_standardize_equal(with_prior):
    data = _batch()
    prior = None
    if with_prior:
        prior = dict(mu0=np.array([82.0, 79.0, 85.0], np.float32),
                     n0=np.array([0.0, 2.0, 5.0], np.float32))
    r = jax.vmap(ref._standardize)(
        jnp.asarray(data["y"]), jnp.asarray(data["mask"]),
        None if prior is None else {k: jnp.asarray(v)
                                    for k, v in prior.items()})
    p = port._standardize(torch.as_tensor(data["y"]),
                          torch.as_tensor(data["mask"]),
                          None if prior is None else from_reference(
                              prior, "cpu"))
    for rv, pv in zip(r, p):
        np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=1e-6,
                                   atol=1e-6)


def test_neg_mll_and_gradient_equal():
    data = _batch()
    theta = _theta(3)
    rd, pd = _both(data)
    y_std_r = jax.vmap(lambda y, m: ref._standardize(y, m)[0])(rd["y"],
                                                               rd["mask"])
    y_std_p = port._standardize(pd["y"], pd["mask"])[0]
    th_r = {k: jnp.asarray(v) for k, v in theta.items()}
    th_p = from_reference(theta, "cpu")
    val_r, g_r = jax.vmap(jax.value_and_grad(ref._neg_mll),
                          in_axes=(0, 0, 0, 0, None))(
        th_r, rd["x"], y_std_r, rd["mask"], CFG_R.jitter)
    val_p = port._neg_mll(th_p, pd["x"], y_std_p, pd["mask"], CFG_P.jitter)
    g_p = port._mll_grad(th_p, pd["x"], y_std_p, pd["mask"], CFG_P.jitter)
    np.testing.assert_allclose(val_p.numpy(), np.asarray(val_r), rtol=1e-5)
    for k in port.THETA_KEYS:
        np.testing.assert_allclose(g_p[k].numpy(), np.asarray(g_r[k]),
                                   rtol=1e-5, atol=1e-5)


def test_adam_update_equal():
    rng = np.random.default_rng(2)
    theta = _theta(4)
    g = {k: rng.standard_normal(4).astype(np.float32) for k in theta}
    m = {k: rng.standard_normal(4).astype(np.float32) * 0.1 for k in theta}
    v = {k: rng.random(4).astype(np.float32) * 0.1 for k in theta}
    j = lambda d: {k: jnp.asarray(x) for k, x in d.items()}  # noqa: E731
    for t in (1.0, 7.0):
        tr, optr = ref._adam_update(j(theta), dict(m=j(m), v=j(v)), j(g),
                                    0.05, jnp.float32(t))
        tp, optp = port._adam_update(from_reference(theta, "cpu"),
                                     from_reference(dict(m=m, v=v), "cpu"),
                                     from_reference(g, "cpu"), 0.05,
                                     torch.tensor(t))
        for k in theta:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(tr[k]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(optp["v"][k].numpy(),
                                       np.asarray(optr["v"][k]), rtol=1e-6)


def test_init_theta_equal():
    r = ref.init_theta(CFG_R)
    p = port.init_theta(CFG_P, (2,), "cpu")
    for k in port.THETA_KEYS:
        assert p[k].shape == (2,) and p[k].dtype == torch.float32
        np.testing.assert_array_equal(p[k].numpy(),
                                      np.full(2, np.float32(r[k])))


def test_cold_fit_batch_equal():
    data = _batch()
    rd, pd = _both(data)
    gr = _np(ref.fit_batch(rd, CFG_R))
    gp = port.fit_batch(pd, CFG_P)
    for k in port.THETA_KEYS:
        np.testing.assert_allclose(gp["theta"][k].numpy(), gr["theta"][k],
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gp["y_mu"].numpy(), gr["y_mu"], rtol=1e-6)
    np.testing.assert_allclose(gp["y_sigma"].numpy(), gr["y_sigma"],
                               rtol=1e-6)
    # a single fit is the one-lane batch
    one = port.fit({k: v[1] for k, v in pd.items()}, CFG_P)
    for k in port.THETA_KEYS:
        np.testing.assert_allclose(one["theta"][k].numpy(),
                                   gp["theta"][k][1].numpy(), rtol=1e-5)


def test_warm_fit_steps_used_equal():
    data = _batch(S=4, seed=3)
    rd, pd = _both(data)
    th0 = _theta(4, seed=4)
    # lanes 0 and 1 start from their cold fit (near the optimum, few
    # steps); lanes 2 and 3 from afar
    cold = _np(ref.fit_batch(rd, ref.GPConfig()))
    for k in th0:
        th0[k][:2] = cold["theta"][k][:2]
    c = CFG_R
    cache_r, steps_r = jax.vmap(lambda d, t: ref._fit_core_from(
        d, c, t, c.warm_steps, c.warm_gtol))(
        rd, {k: jnp.asarray(v) for k, v in th0.items()})
    cache_p, steps_p = port._fit_core_from(
        pd, CFG_P, from_reference(th0, "cpu"), CFG_P.warm_steps,
        CFG_P.warm_gtol)
    np.testing.assert_array_equal(steps_p.numpy(), np.asarray(steps_r))
    assert steps_p.dtype == torch.int32
    assert len(set(steps_p.tolist())) > 1      # lanes stop at different steps
    for k in port.THETA_KEYS:
        np.testing.assert_allclose(cache_p["theta"][k].numpy(),
                                   np.asarray(cache_r["theta"][k]),
                                   rtol=1e-4, atol=1e-4)


def _ref_cache(S=3, seed=0):
    data = _batch(S=S, seed=seed)
    cache = _np(ref.fit_batch({k: jnp.asarray(v) for k, v in data.items()},
                              CFG_R))
    return cache, from_reference(cache, "cpu")


U32 = 2.0 ** -24                     # float32 unit roundoff


def _sigma64(cache, A):
    """sigma of each lane's posterior at A in float64 from the cache's own
    float32 values (theta, L, x, mask, y_sigma), and the bound on a
    float32 evaluation's error. With n data rows, the float32 kernel
    values, the backward-stable triangular solve and the sum of n squares
    make at most 2n roundings, each relative to the terms that cancel, so
    the variance errs by at most 2 n u (sv + |L^-1 k|^2) to first order;
    the bound on sigma is that interval's image under sqrt(.) y_sigma."""
    from scipy.linalg import solve_triangular

    sig, bound = [], []
    for b in range(A.shape[0]):
        ls = np.exp(np.float64(cache["theta"]["log_ls"][b]))
        sv = np.exp(np.float64(cache["theta"]["log_sv"][b]))
        x = cache["x"][b].astype(np.float64)
        r = np.sqrt(((x[:, None] - A[b][None].astype(np.float64)) ** 2
                     ).sum(-1)) / ls
        k = (sv * (1 + np.sqrt(5) * r + 5 * r * r / 3) * np.exp(
            -np.sqrt(5) * r) * cache["mask"][b][:, None])
        v = solve_triangular(cache["L"][b].astype(np.float64), k,
                             lower=True)
        s2 = np.sum(v * v, axis=0)
        var, tol = sv - s2, 2 * x.shape[0] * U32 * (sv + s2)
        ys = np.float64(cache["y_sigma"][b])
        sig.append(np.sqrt(np.maximum(var, 1e-12)) * ys)
        bound.append(ys * (np.sqrt(np.maximum(var + tol, 1e-12))
                           - np.sqrt(np.maximum(var - tol, 1e-12))))
    return np.array(sig), np.array(bound)


def _assert_sigma(sig, sig64, bound):
    err = np.abs(np.asarray(sig, np.float64) - sig64)
    assert np.all(err <= bound), (err.max(), bound.flat[err.argmax()])


def test_posteriors_equal_given_the_same_cache():
    cache_r, cache_p = _ref_cache()
    rng = np.random.default_rng(5)
    A = rng.random((3, 50, 2)).astype(np.float32)
    cj = jax.tree.map(jnp.asarray, cache_r)
    mu_r, sig_r = jax.vmap(ref.posterior_batch)(cj, jnp.asarray(A))
    mu_p, sig_p = port.posterior_batch(cache_p, torch.as_tensor(A))
    sig64, bound = _sigma64(cache_r, A)
    np.testing.assert_allclose(mu_p.numpy(), np.asarray(mu_r), rtol=1e-5)
    _assert_sigma(sig_p.numpy(), sig64, bound)
    _assert_sigma(sig_r, sig64, bound)
    mu_r, sig_r, g_r = jax.vmap(ref.posterior_with_grad_batch)(
        cj, jnp.asarray(A))
    mu_p, sig_p, g_p = port.posterior_with_grad_batch(cache_p,
                                                      torch.as_tensor(A))
    np.testing.assert_allclose(mu_p.numpy(), np.asarray(mu_r), rtol=1e-5)
    _assert_sigma(sig_p.numpy(), sig64, bound)
    _assert_sigma(sig_r, sig64, bound)
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_r), rtol=1e-5,
                               atol=1e-4)
    # one lane without the lane axis, as the single-point posterior
    lane = port.take_lanes(cache_p, 0)
    mu1, sig1 = port.posterior(lane, torch.as_tensor(A[0, 0]))
    np.testing.assert_allclose(float(mu1), float(mu_p[0, 0]), rtol=1e-6)


def test_posterior_mean_gradient_matches_autograd():
    _, cache_p = _ref_cache()
    A = torch.as_tensor(np.random.default_rng(6).random((3, 9, 2)),
                        dtype=torch.float32).requires_grad_(True)
    mu, _, g = port.posterior_with_grad_batch(cache_p, A)
    (auto,) = torch.autograd.grad(mu.sum(), A)
    np.testing.assert_allclose(g.detach().numpy(), auto.numpy(), rtol=1e-4,
                               atol=1e-3)


def test_indefinite_cholesky_is_nan_like_jax():
    """An indefinite lane gets a factor that is NaN on and below the
    diagonal (JAX's behaviour, which ``theta_finite`` relies on); a
    positive definite lane is unchanged."""
    K = np.stack([np.eye(3) * 2.0, -np.eye(3),
                  [[1, 2, 0], [2, 1, 0], [0, 0, 1]]]).astype(np.float32)
    ref_L = np.asarray(jnp.linalg.cholesky(jnp.asarray(K)))
    got = port.cholesky(torch.as_tensor(K)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref_L))
    assert np.isnan(got[1:]).any()
    np.testing.assert_allclose(got[0], ref_L[0], rtol=1e-6)
    # the MLL's log-determinant sends NaN back into a failed lane's
    # gradient, as through JAX's factor; a good lane stays finite
    Kt = torch.as_tensor(K).requires_grad_(True)
    logdet = torch.log(torch.diagonal(port.cholesky(Kt), dim1=-2, dim2=-1))
    (g,) = torch.autograd.grad(logdet.sum(), Kt)
    assert torch.isnan(g[1]).any() and torch.isfinite(g[0]).all()


def test_poisoned_fit_is_flagged_and_scrub_recovers():
    data = _batch()
    data["y"][1, 2] = np.nan
    rd, pd = _both(data)
    gr = ref.fit_batch(rd, ref.GPConfig(fit_steps=5))
    gp = port.fit_batch(pd, port.GPConfig(fit_steps=5))
    np.testing.assert_array_equal(port.theta_finite(gp["theta"]).numpy(),
                                  np.asarray(ref.theta_finite(gr["theta"])))
    assert port.theta_finite(gp["theta"]).tolist() == [True, False, True]
    sr = _np(ref.scrub_dataset(rd))
    sp = port.scrub_dataset(pd)
    for k in ("x", "y", "mask"):
        np.testing.assert_array_equal(sp[k].numpy(), sr[k])
    clean = port.fit_batch(sp, port.GPConfig(fit_steps=5))
    assert port.theta_finite(clean["theta"]).all()


def test_buckets_and_lane_helpers():
    for n in (0, 1, 15, 16, 17, 40, 64, 90):
        assert port.bucket_size(n, 64) == ref.bucket_size(n, 64)
        assert port.bucket_size(n, 40) == ref.bucket_size(n, 40)
    np.testing.assert_array_equal(port.pad_lanes_index(3, 8),
                                  ref.pad_lanes_index(3, 8))
    with pytest.raises(ValueError):
        port.pad_lanes_index(4, 2)
    data = _batch()
    sl = port.slice_data(data, 8)
    np.testing.assert_array_equal(sl["x"], data["x"][:, :8])
    one = port.slice_data({k: v[0] for k, v in data.items()}, 8)
    np.testing.assert_array_equal(one["mask"], data["mask"][0, :8])
    _, cache_p = _ref_cache()
    idx = torch.tensor([2, 0])
    lanes = port.take_lanes(cache_p, idx)
    assert torch.equal(lanes["theta"]["log_ls"],
                       cache_p["theta"]["log_ls"][idx])
    assert torch.equal(lanes["L"], cache_p["L"][idx])
