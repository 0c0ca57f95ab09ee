"""The port's ``models/moe.py`` and ``attention.blocked_attention``
against the reference (``repro.models.moe``, ``repro.models.attention``)
on the CPU, on the same numpy-seeded inputs and the reference's
initialized MoE parameters carried across: routing (ids, weights, aux),
capacity dispatch without and with drops (the stable sort decides which
assignments overflow), the ragged path and its ``ragged_dot``, fp8
expert weights bit for bit, and the same call twice bit for bit; and
blocked attention, the triangular schedule included, against both
packages' other paths.

Tolerances: functions atol 1e-5, rtol 1e-5 (float32, the same operations
in another order); blocked attention against naive atol 2e-5, rtol 1e-3
(the reference's own bar, ``tests/test_models_losses.py``). Integer
outputs (top-k ids, fp8 bits) exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import attention as ref_attn
from repro.models import moe as ref_moe
from repro.models.common import init_params
from repro_torch.configs import get_config, reduced
from repro_torch.models import attention as port_attn
from repro_torch.models import moe as port_moe

torch.set_num_threads(1)
F_ATOL = F_RTOL = 1e-5
B, S = 2, 64
ARCH = "qwen2-moe-a2.7b"


def configs(**replace):
    return (dataclasses.replace(ref_reduced(ref_get_config(ARCH)), **replace),
            dataclasses.replace(reduced(get_config(ARCH)), **replace))


@pytest.fixture(scope="module")
def params():
    """The reference's MoE leaves (reduced Qwen2-MoE: 8 experts, top-2,
    one shared expert), as JAX arrays."""
    cfg, _ = configs()
    return init_params(jax.random.PRNGKey(0), ref_moe.moe_template(cfg),
                       jnp.float32)


def port_layer(pcfg, p):
    """The port's ``MoE`` holding the reference leaves ``p``."""
    mod = port_moe.MoE(pcfg, device="cpu", dtype=torch.float32)
    for name, leaf in jax.tree_util.tree_leaves_with_path(p):
        key = ".".join(k.key for k in name)
        mod.get_parameter(key).data = torch.tensor(np.asarray(leaf))
    return mod


def hidden(cfg, seed=1, batch=B, seq=S):
    x = np.random.default_rng(seed).standard_normal(
        (batch, seq, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x), torch.as_tensor(x)


def both_apply(params, x_seed=1, **replace):
    cfg, pcfg = configs(**replace)
    jx, tx = hidden(cfg, x_seed)
    want, want_aux = ref_moe.moe_apply(params, jx, cfg, None)
    got, aux = port_moe.moe_apply(port_layer(pcfg, params), tx, pcfg)
    return (got, aux), (np.asarray(want), float(want_aux))


def test_template_has_the_reference_leaves(params):
    cfg, pcfg = configs()
    mod = port_layer(pcfg, params)
    want = {".".join(k.key for k in path): tuple(np.shape(leaf))
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    assert {n: tuple(p.shape) for n, p in mod.named_parameters()} == want
    assert mod.router.init == "small" and mod.wg.init == "normal"


# ---------------------------------------------------------------------------
# routing and dispatch
# ---------------------------------------------------------------------------


def test_route_gives_the_reference_ids_weights_and_aux(params):
    cfg, pcfg = configs()
    jx, tx = hidden(cfg)
    D = cfg.d_model
    w, i, aux = ref_moe._route(jx.reshape(-1, D), params["router"], cfg)
    gw, gi, gaux = port_moe._route(tx.reshape(-1, D),
                                   torch.tensor(np.asarray(params["router"])),
                                   pcfg)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(i))
    np.testing.assert_allclose(gw.numpy(), np.asarray(w), atol=F_ATOL,
                               rtol=F_RTOL)
    np.testing.assert_allclose(float(gaux), float(aux), atol=F_ATOL,
                               rtol=F_RTOL)


def _dense_moe_ref(p, x, cfg):
    """Loop over experts (no capacity drops): the reference test's
    oracle, in numpy."""
    xt = np.asarray(x).reshape(-1, cfg.d_model)
    topw, topi, _ = ref_moe._route(jnp.asarray(xt), p["router"], cfg)
    topw, topi = np.asarray(topw), np.asarray(topi)
    out = np.zeros_like(xt)
    for e in range(cfg.n_experts):
        g = xt @ np.asarray(p["wg"][e])
        h = (g / (1 + np.exp(-g)) * (xt @ np.asarray(p["wu"][e]))
             ) @ np.asarray(p["wd"][e])
        for kk in range(cfg.top_k):
            sel = topi[:, kk] == e
            out[sel] += topw[sel, kk, None] * h[sel]
    return out.reshape(np.shape(x))


@pytest.mark.parametrize("dispatch", ["capacity", "ragged"])
def test_dispatch_matches_dense_reference(params, dispatch):
    """Mirrors ``test_moe_sorted_dispatch_matches_dense_reference``: no
    shared expert, capacity factor 8 (nothing drops)."""
    p = {k: v for k, v in params.items() if k != "shared"}
    (got, aux), (want, want_aux) = both_apply(
        p, n_shared_experts=0, capacity_factor=8.0, moe_dispatch=dispatch)
    cfg, _ = configs(n_shared_experts=0)
    jx, _ = hidden(cfg)
    np.testing.assert_allclose(got.numpy(), _dense_moe_ref(p, jx, cfg),
                               atol=2e-4, rtol=1e-2)
    np.testing.assert_allclose(got.numpy(), want, atol=F_ATOL, rtol=F_RTOL)
    assert np.isfinite(float(aux))


def _dropped(params, cfg, capacity_factor):
    """Assignments past their expert's capacity, counted from the
    reference's routing."""
    cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    jx, _ = hidden(cfg)
    _, topi, _ = ref_moe._route(jx.reshape(-1, cfg.d_model),
                                params["router"], cfg)
    T = jx.shape[0] * jx.shape[1]
    C = max(int(T * cfg.top_k * capacity_factor / cfg.n_experts), 4)
    load = np.bincount(np.asarray(topi).reshape(-1),
                       minlength=cfg.n_experts)
    return int(np.maximum(load - C, 0).sum()), T * cfg.top_k


@pytest.mark.parametrize("capacity_factor", [4.0, 0.5])
def test_capacity_dispatch_with_shared_expert(params, capacity_factor):
    """At capacity factor 0.5 about half the assignments overflow: the
    port must drop the same ones (its rank within an expert comes from a
    stable sort, as ``jnp.argsort``'s)."""
    (got, aux), (want, want_aux) = both_apply(
        params, capacity_factor=capacity_factor)
    dropped, A = _dropped(params, configs()[0], capacity_factor)
    assert (dropped == 0) if capacity_factor == 4.0 else (dropped > A // 3)
    np.testing.assert_allclose(got.numpy(), want, atol=F_ATOL, rtol=F_RTOL)
    np.testing.assert_allclose(float(aux), want_aux, atol=F_ATOL,
                               rtol=F_RTOL)


def test_capacity_per_expert_floor_of_four(params):
    """T k cf / E under 4 (one decode token) keeps a capacity of 4."""
    cfg, pcfg = configs(capacity_factor=1.5)
    jx, tx = hidden(cfg, seed=3, batch=2, seq=1)
    want, _ = ref_moe.moe_apply(params, jx, cfg, None)
    got, _ = port_moe.moe_apply(port_layer(pcfg, params), tx, pcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F_ATOL,
                               rtol=F_RTOL)


@pytest.mark.parametrize("sizes", [[3, 0, 5, 2], [1, 1, 0, 0]])
def test_ragged_dot_matches_jax(sizes):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((10, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6, 5)).astype(np.float32)
    want = jax.lax.ragged_dot(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(sizes, jnp.int32))
    got = port_moe.ragged_dot(torch.as_tensor(x), torch.as_tensor(w),
                              torch.tensor(sizes))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F_ATOL,
                               rtol=F_RTOL)


def test_ragged_dispatch_matches_reference(params):
    (got, aux), (want, want_aux) = both_apply(params, moe_dispatch="ragged")
    np.testing.assert_allclose(got.numpy(), want, atol=F_ATOL, rtol=F_RTOL)
    np.testing.assert_allclose(float(aux), want_aux, atol=F_ATOL,
                               rtol=F_RTOL)


def test_fp8_experts_bit_for_bit(params):
    """``moe_weight_dtype="float8_e4m3fn"``: the quantized experts and
    their scales equal the reference's bit for bit, and the layer its
    output."""
    cfg, pcfg = configs(moe_weight_dtype="float8_e4m3fn")
    ws = [params[n] for n in ("wg", "wu", "wd")]
    want = ref_moe._maybe_quant_experts(cfg, *ws)
    got = port_moe._maybe_quant_experts(
        pcfg, *(torch.tensor(np.asarray(w)) for w in ws))
    for (gq, gs), (wq, wsc) in zip(got, want):
        assert gq.dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(
            gq.view(torch.uint8).numpy(),
            np.asarray(wq).view(np.uint8))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(wsc))
        np.testing.assert_array_equal(
            port_moe._dequant(gq, gs, torch.float32).numpy(),
            np.asarray(ref_moe._dequant(wq, wsc, jnp.float32)))
    (out, _), (want_out, _) = both_apply(
        params, moe_weight_dtype="float8_e4m3fn")
    np.testing.assert_allclose(out.numpy(), want_out, atol=F_ATOL,
                               rtol=F_RTOL)


@pytest.mark.parametrize("dispatch", ["capacity", "ragged"])
def test_same_call_twice_bit_for_bit(params, dispatch):
    _, pcfg = configs(moe_dispatch=dispatch, capacity_factor=0.5)
    layer = port_layer(pcfg, params)
    _, tx = hidden(pcfg)
    a, aux_a = port_moe.moe_apply(layer, tx, pcfg)
    b, aux_b = port_moe.moe_apply(layer, tx, pcfg)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


# ---------------------------------------------------------------------------
# blocked attention
# ---------------------------------------------------------------------------


def _qkv(seed, B_, S_, Hq, Hkv, hd):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B_, S_, Hq, hd), (B_, S_, Hkv, hd),
                         (B_, S_, Hkv, hd)))
    pos = np.broadcast_to(np.arange(S_, dtype=np.int32), (B_, S_)).copy()
    return (q, k, v, pos, pos)


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 2), st.sampled_from([64, 96, 128]),
       st.sampled_from([(4, 2), (4, 4), (8, 1)]), st.sampled_from([0, 24]))
def test_blocked_attention_matches_naive_and_reference(B_, S_, heads,
                                                       window):
    """The reference's hypothesis cases, through both packages'
    ``blocked_attention`` and the port's ``naive_attention``."""
    args = _qkv(B_ * S_ + heads[0], B_, S_, *heads, 16)
    got = port_attn.blocked_attention(*map(torch.as_tensor, args), window,
                                      q_block=32, kv_block=32)
    naive = port_attn.naive_attention(*map(torch.as_tensor, args), window)
    want = ref_attn.blocked_attention(*map(jnp.asarray, args), window,
                                      q_block=32, kv_block=32)
    np.testing.assert_allclose(got.numpy(), naive.numpy(), atol=2e-5,
                               rtol=1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F_ATOL,
                               rtol=F_RTOL)


@pytest.mark.parametrize("S_, window, q_block, kv_block", [
    (256, 0, 64, 64), (200, 0, 64, 32), (130, 40, 32, 64)])
def test_blocked_attention_causal_skip(S_, window, q_block, kv_block):
    """The triangular schedule equals the plain scan and the reference's
    triangular schedule; ragged S pads q and KV (padded KV slots at
    INT32_MAX positions)."""
    args = _qkv(5, 2, S_, 4, 2, 32)
    targs = list(map(torch.as_tensor, args))
    plain = port_attn.blocked_attention(*targs, window, q_block=q_block,
                                        kv_block=kv_block)
    skip = port_attn.blocked_attention(*targs, window, q_block=q_block,
                                       kv_block=kv_block, causal_skip=True)
    want = ref_attn.blocked_attention(*map(jnp.asarray, args), window,
                                      q_block=q_block, kv_block=kv_block,
                                      causal_skip=True)
    np.testing.assert_allclose(skip.numpy(), plain.numpy(), atol=2e-5,
                               rtol=1e-3)
    np.testing.assert_allclose(skip.numpy(), np.asarray(want), atol=F_ATOL,
                               rtol=F_RTOL)
