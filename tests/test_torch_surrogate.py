"""The port's surrogates against ``repro.core.surrogate`` on the same
data: the random-feature basis is the reference's numpy draw, bit for
bit; the RFF weights agree within rtol 1e-3 (a 512 x 512 float32
Cholesky solve) and its posterior within rtol 1e-4 of each quantity's
scale; the exact-GP surrogate is ``gp.fit_batch``."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import surrogate as ref
from repro_torch.core import acquisition as port_acq
from repro_torch.core import gp as port_gp
from repro_torch.core import surrogate as port
from repro_torch.core.batch_bo import BatchedBayesSplitEdge, Scenario
from repro_torch.core.engine_config import EngineConfig
from repro_torch.core.problem import default_vgg19_problem
from repro_torch.interop import from_reference

torch.set_num_threads(1)


def _data(S=2, m=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((S, m, 2)).astype(np.float32)
    y = (80 + 4 * x[..., 0] - 2 * x[..., 1] ** 2
         + 0.05 * rng.standard_normal((S, m))).astype(np.float32)
    mask = np.arange(m)[None] < np.array([[9], [14]])[:S]
    return dict(x=np.where(mask[..., None], x, 0).astype(np.float32),
                y=np.where(mask, y, 0).astype(np.float32), mask=mask)


def test_rff_basis_is_the_reference_draw():
    for args in ((512, 0, 2), (64, 3, 5)):
        for a, b in zip(port._rff_basis(*args), ref._rff_basis(*args)):
            np.testing.assert_array_equal(a, b)


def test_rff_fit_and_posterior_equal():
    data = _data()
    rs, ps = ref.RandomFeatureSurrogate(), port.RandomFeatureSurrogate()
    model_r, steps_r = rs.fit({k: jnp.asarray(v) for k, v in data.items()})
    model_p, steps_p = ps.fit(from_reference(data, "cpu"))
    np.testing.assert_array_equal(steps_p.numpy(), np.asarray(steps_r))
    np.testing.assert_allclose(model_p["coef"].numpy(),
                               np.asarray(model_r["coef"]), rtol=1e-3,
                               atol=1e-3)
    A = np.random.default_rng(1).random((2, 30, 2)).astype(np.float32)
    out_r = jax.vmap(rs.posterior_with_grad)(model_r, jnp.asarray(A))
    out_p = ps.posterior_with_grad(model_p, torch.as_tensor(A))
    for name, r, p in zip(("mu", "sigma", "dmu"), out_r, out_p):
        scale = float(np.max(np.abs(np.asarray(r))))
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)


def test_gp_surrogate_is_the_exact_gp():
    data = from_reference(_data(), "cpu")
    cfg = port_gp.GPConfig(fit_steps=30)
    model, steps = port.GPSurrogate(cfg).fit(data)
    direct = port_gp.fit_batch(data, cfg)
    assert steps.tolist() == [30, 30]
    for k in port_gp.THETA_KEYS:
        assert torch.equal(model["theta"][k], direct["theta"][k])
    warm, wsteps = port.GPSurrogate(cfg).fit_from(data, direct["theta"])
    assert wsteps.dtype == torch.int32 and (wsteps <= cfg.warm_steps).all()
    assert port.resolve(None, cfg) == port.GPSurrogate(cfg)
    assert isinstance(port.GPSurrogate(), port.Surrogate)
    assert isinstance(port.RandomFeatureSurrogate(), port.Surrogate)


def test_block_posterior_with_rff_uses_its_own_posterior():
    data = from_reference(_data(), "cpu")
    rs = port.RandomFeatureSurrogate()
    model, _ = rs.fit(data)
    cand = torch.as_tensor(np.random.default_rng(2).random((2, 11, 2)),
                           dtype=torch.float32)
    for a, b in zip(port_acq.block_posterior(model, cand, rs),
                    rs.posterior_with_grad(model, cand)):
        assert torch.equal(a, b)


def test_batched_engine_runs_with_rff():
    scs = [Scenario(default_vgg19_problem(), seed=s, budget=13)
           for s in (0, 1)]
    res = BatchedBayesSplitEdge(
        scs, config=EngineConfig(surrogate=port.RandomFeatureSurrogate()),
        device="cpu").run()
    assert [r.n_evals for r in res] == [13, 13]
    assert all(r.best_a is not None for r in res)
