"""The port's recurrent layers against the reference on the CPU, on the
same numpy-seeded inputs and the reference's initialized parameters:
RG-LRU (``models/rglru.py``: the causal conv, the gates, the log-add
softplus and ``rglru_apply`` through every route of the reference's
recurrence) and RWKV6 (``models/rwkv6.py``: token shift, per-head group
norm, time mix with its wkv scan, channel mix), each with and without a
state, which the port updates in place to the reference's returned
state.

Tolerances: functions atol 1e-5, rtol 1e-5 (float32, the same operations
in another order); the layers atol 1e-4, rtol 1e-3, the bar the model
forward is held to in ``tests/test_torch_models.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import common as ref_common
from repro.models import rglru as ref_rglru
from repro.models import rwkv6 as ref_rwkv
from repro_torch.configs import get_config, reduced
from repro_torch.models import rglru as port_rglru
from repro_torch.models import rwkv6 as port_rwkv

torch.set_num_threads(1)
F_ATOL = F_RTOL = 1e-5
JNP_ATOL, JNP_RTOL = 1e-4, 1e-3


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_cfg(arch, **replace):
    return dataclasses.replace(reduced(get_config(arch)), **replace)


def _rng_arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _carry(module, tree):
    for name, leaf in tree.items():
        module.get_parameter(name).data = torch.tensor(np.asarray(leaf))


def _rglru_pair(seed=11, **replace):
    cfg = dataclasses.replace(ref_reduced(ref_get_config(
        "recurrentgemma-2b")), **replace)
    p = ref_common.init_params(jax.random.PRNGKey(seed),
                               ref_rglru.rglru_template(cfg))
    # non-zero biases and a spread of decay rates, so all are exercised
    R = cfg.lru_width
    p = dict(p, conv_b=p["conv_b"] + 0.1, ba=p["ba"] - 0.2, bx=p["bx"] + 0.3,
             lam=jnp.linspace(-3.0, 25.0, R))
    mod = port_rglru.RGLRU(port_cfg("recurrentgemma-2b", **replace),
                           device="cpu", dtype=torch.float32)
    _carry(mod, np_tree(p))
    return cfg, p, mod


def test_rglru_conv_gates_and_softplus():
    cfg, p, mod = _rglru_pair()
    R, cw = cfg.lru_width, cfg.conv1d_width
    u, hist = _rng_arrays(12, (2, 9, R), (2, cw - 1, R))
    for cache in (None, hist):
        got, got_c = port_rglru.causal_conv(
            mod, torch.as_tensor(u), None if cache is None
            else torch.as_tensor(cache))
        want, want_c = ref_rglru._causal_conv(
            p, jnp.asarray(u), None if cache is None else jnp.asarray(cache))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=F_ATOL, rtol=F_RTOL)
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    for g, w in zip(port_rglru.gates(mod, torch.as_tensor(u)),
                    ref_rglru._gates(p, jnp.asarray(u), cfg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=F_ATOL,
                                   rtol=F_RTOL)
    lam = np.linspace(-30.0, 60.0, 181, dtype=np.float32)  # past 20 too
    np.testing.assert_allclose(
        port_rglru.softplus(torch.as_tensor(lam)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(lam))), atol=0, rtol=1e-6)


@pytest.mark.parametrize("S", [1, 2, 24])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("pallas", [False, True])
def test_rglru_apply_matches_reference(S, with_state, pallas):
    """Every route of the reference's recurrence: S = 1 inline, the
    associative scan, and its Pallas kernel in interpret mode (S > 1);
    the port's state dict is updated in place to the reference's."""
    cfg, p, mod = _rglru_pair(use_pallas_kernels=pallas)
    R, cw = cfg.lru_width, cfg.conv1d_width
    x, h, conv = _rng_arrays(13, (2, S, cfg.d_model), (2, R),
                             (2, cw - 1, R))
    rstate = (dict(h=jnp.asarray(h), conv=jnp.asarray(conv))
              if with_state else None)
    state = (dict(h=torch.as_tensor(h), conv=torch.as_tensor(conv))
             if with_state else None)
    want, wstate = ref_rglru.rglru_apply(p, jnp.asarray(x), cfg, rstate)
    got, gstate = port_rglru.rglru_apply(mod, torch.as_tensor(x), state)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=JNP_ATOL, rtol=JNP_RTOL)
    if with_state:
        assert gstate is state
        for name in ("h", "conv"):
            assert state[name].dtype == torch.float32
            np.testing.assert_allclose(state[name].numpy(),
                                       np.asarray(wstate[name]),
                                       atol=F_ATOL, rtol=F_RTOL)
    else:
        assert gstate is None


def _rwkv_pair(seed=21):
    cfg = ref_reduced(ref_get_config("rwkv6-3b"))
    p = ref_common.init_params(jax.random.PRNGKey(seed),
                               ref_rwkv.rwkv_template(cfg))
    p = dict(p, gn_b=p["gn_b"] + 0.1, w0=p["w0"] + 0.5)
    mod = port_rwkv.RWKVMix(port_cfg("rwkv6-3b"), device="cpu",
                            dtype=torch.float32)
    _carry(mod, np_tree(p))
    return cfg, p, mod


def test_rwkv_shift_and_groupnorm():
    x, prev, w, b = _rng_arrays(22, (2, 5, 32), (2, 32), (32,), (32,))
    for pv in (None, prev):
        got = port_rwkv.shift(torch.as_tensor(x),
                              None if pv is None else torch.as_tensor(pv))
        want = ref_rwkv._shift(jnp.asarray(x),
                               None if pv is None else jnp.asarray(pv))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    xh = x.reshape(2, 5, 2, 16)
    got = port_rwkv.groupnorm_heads(torch.as_tensor(xh), torch.as_tensor(w),
                                    torch.as_tensor(b))
    want = ref_rwkv._groupnorm_heads(jnp.asarray(xh), jnp.asarray(w),
                                     jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F_ATOL,
                               rtol=F_RTOL)


@pytest.mark.parametrize("S", [1, 24])
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_mixes_match_reference(S, with_state):
    """Time mix (the wkv scan included) and channel mix, with the
    block's state dict updated in place to the reference's states."""
    cfg, p, mod = _rwkv_pair()
    H, hd, D = cfg.n_rwkv_heads, cfg.rwkv_head_dim, cfg.d_model
    x, s, xp_tm, xp_cm = _rng_arrays(23, (2, S, D), (2, H, hd, hd), (2, D),
                                     (2, D))
    state = (dict(s=torch.as_tensor(s), x_prev_tm=torch.as_tensor(xp_tm),
                  x_prev_cm=torch.as_tensor(xp_cm)) if with_state else None)
    rtm = (dict(s=jnp.asarray(s), x_prev=jnp.asarray(xp_tm))
           if with_state else None)
    rcm = dict(x_prev=jnp.asarray(xp_cm)) if with_state else None
    want, wtm = ref_rwkv.rwkv_time_mix(p, jnp.asarray(x), cfg, rtm)
    got, _ = port_rwkv.rwkv_time_mix(mod, torch.as_tensor(x), cfg, state)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=JNP_ATOL,
                               rtol=JNP_RTOL)
    want, wcm = ref_rwkv.rwkv_channel_mix(p, jnp.asarray(x), cfg, rcm)
    got, _ = port_rwkv.rwkv_channel_mix(mod, torch.as_tensor(x), cfg, state)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=JNP_ATOL,
                               rtol=JNP_RTOL)
    if with_state:
        for name, w in (("s", wtm["s"]), ("x_prev_tm", wtm["x_prev"]),
                        ("x_prev_cm", wcm["x_prev"])):
            np.testing.assert_allclose(state[name].numpy(), np.asarray(w),
                                       atol=F_ATOL, rtol=F_RTOL)
