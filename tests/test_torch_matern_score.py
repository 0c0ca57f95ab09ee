"""The port's plain ``matern_score`` (what ``ops.matern_score`` returns
for CPU tensors, and what the CUDA kernel is held against on the card)
against the reference's jnp oracle and its Pallas kernel in interpret
mode, at the main path's bucket sizes and a ragged candidate count.
Tolerance rtol 1e-5, atol 1e-6 (float32, summation order differs)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.matern_score.ops import matern_score as ref_op
from repro.kernels.matern_score.ref import matern_score_ref as ref_oracle
from repro_torch.core import gp as port_gp
from repro_torch.kernels.matern_score import (matern_posterior,
                                              matern_score, matern_score_ref)

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
N_RAGGED = 203          # not a multiple of the TPU block (128) or of 8


def _inputs(S, N, n, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.random((S, N, 2)).astype(f), rng.random((S, n, 2)).astype(f),
            rng.standard_normal((S, n)).astype(f),
            (rng.random((S, n)) < 0.8).astype(f),
            (0.1 + rng.random(S)).astype(f), (0.5 + rng.random(S)).astype(f))


@pytest.mark.parametrize("n", [16, 32, 48, 64])
@pytest.mark.parametrize("against", ["jnp_oracle", "pallas_interpret"])
def test_plain_version_matches_reference(n, against):
    args = _inputs(3, N_RAGGED, n, seed=n)
    jargs = [jnp.asarray(a) for a in args]
    if against == "jnp_oracle":
        want = np.asarray(ref_oracle(*jargs))
    else:
        want = np.asarray(ref_op(*jargs, block_n=128, interpret=True,
                                 use_ref=False))
    targs = [torch.as_tensor(a) for a in args]
    got = matern_score(*targs)
    assert got.shape == (3, N_RAGGED) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert torch.equal(got, matern_score_ref(*targs))


def test_plain_version_is_the_posterior_mean():
    """The score of a fitted GP is its standardized posterior mean, as
    ``gp.posterior_with_grad_batch`` computes it (ks^T alpha), and on the
    raw scale it is the posterior entry's mean, bit for bit."""
    rng = np.random.default_rng(3)
    S, m = 2, 16
    x = rng.random((S, m, 2)).astype(np.float32)
    y = (rng.random((S, m)) * 5 + 80).astype(np.float32)
    mask = np.arange(m)[None] < np.array([[10], [13]])
    data = port_gp.as_dataset(dict(x=np.where(mask[..., None], x, 0),
                                   y=np.where(mask, y, 0), mask=mask), "cpu")
    gp = port_gp.fit_batch(data, port_gp.GPConfig())
    cand = torch.as_tensor(rng.random((S, 57, 2)), dtype=torch.float32)
    mu, _, _ = port_gp.posterior_with_grad_batch(gp, cand)
    mu_std = (mu - gp["y_mu"][:, None]) / gp["y_sigma"][:, None]
    ls = torch.exp(gp["theta"]["log_ls"])
    sv = torch.exp(gp["theta"]["log_sv"])
    score = matern_score(cand, gp["x"], gp["alpha"], gp["mask"].float(), ls,
                         sv)
    np.testing.assert_allclose(score.numpy(), mu_std.numpy(), rtol=1e-4,
                               atol=1e-5)
    # the posterior entry's mean is the score on the raw scale
    mu_k, _, _ = matern_posterior(cand, gp["x"], gp["alpha"],
                                  gp["mask"].float(), gp["L"], ls, sv,
                                  gp["y_mu"], gp["y_sigma"])
    assert torch.equal(mu_k, score * gp["y_sigma"][:, None]
                       + gp["y_mu"][:, None])


def test_masked_points_contribute_nothing():
    args = [torch.as_tensor(a) for a in _inputs(2, 40, 16, seed=1)]
    cand, x, alpha, mask, ls, sv = args
    mask = torch.zeros_like(mask)
    assert torch.equal(matern_score(cand, x, alpha, mask, ls, sv),
                       torch.zeros(2, 40))
    # a NaN-free result at a candidate that sits on a training point
    cand[0, 0] = x[0, 0]
    out = matern_score(cand, x, alpha, torch.ones_like(mask), ls, sv)
    assert torch.all(torch.isfinite(out))
