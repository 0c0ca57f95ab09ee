"""The port's model layer (``repro_torch.models``) against the reference
(``repro.models``) on the CPU: norms, RoPE, the MLP types and the QKV
projection on the same numpy-seeded inputs, and the whole ``forward``
(mode ``train``) of every registered arch in reduced form (RecurrentGemma
also at 8 layers, which adds its trailing single-block groups; the MoE
archs with their aux loss; Qwen2-1.5B also at S 1100, where both
packages take the blocked attention path) with the reference's
initialized parameters carried across (``interop.model_from_reference``),
the weight carry-over, the init rules and the cache layout. The
recurrent layers' own functions are held in
``tests/test_torch_recurrent_layers.py``, the MoE layer's in
``tests/test_torch_moe.py``.

Tolerances: functions atol 1e-5, rtol 1e-5 (float32, the same
operations in another order); the model forward atol 1e-4, rtol 1e-3
against the reference's jnp path, and atol 5e-4, rtol 1e-2 against its
Pallas kernels in interpret mode, as ``tests/test_integration.py`` holds
the two reference routes to each other."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import attention as ref_attn
from repro.models import common as ref_common
from repro.models import mlp as ref_mlp
from repro.models import transformer as ref_tfm
from repro_torch.configs import get_config, reduced
from repro_torch.interop import model_from_reference
from repro_torch.models import attention as port_attn
from repro_torch.models import common as port_common
from repro_torch.models import frontends
from repro_torch.models import mlp as port_mlp
from repro_torch.models import transformer as port_tfm

torch.set_num_threads(1)
F_ATOL = F_RTOL = 1e-5
JNP_ATOL, JNP_RTOL = 1e-4, 1e-3
PALLAS_ATOL, PALLAS_RTOL = 5e-4, 1e-2
B, S = 2, 64
DENSE_ARCHS = ["qwen2-1.5b", "deepseek-7b", "h2o-danube-3-4b",
               "starcoder2-15b", "musicgen-large", "internvl2-26b"]
RECURRENT = [("recurrentgemma-2b", {}), ("recurrentgemma-2b",
                                         dict(n_layers=8)),
             ("rwkv6-3b", {})]
RECURRENT_IDS = ["recurrentgemma", "recurrentgemma_8_layers", "rwkv6"]
MOE_ARCHS = ["qwen2-moe-a2.7b", "kimi-k2-1t-a32b"]


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def ref_model(arch, **replace):
    cfg = dataclasses.replace(ref_reduced(ref_get_config(arch)), **replace)
    return cfg, ref_tfm.init_model(jax.random.PRNGKey(0), cfg)


def port_cfg(arch, **replace):
    return dataclasses.replace(reduced(get_config(arch)), **replace)


def inputs(cfg, seed=1, batch=B, seq=S):
    """(reference kwargs, port kwargs) of the same tokens or embeds."""
    rng = np.random.default_rng(seed)
    if frontends.uses_embeds(cfg):
        e = (rng.standard_normal((batch, seq, cfg.d_model)) * 0.02
             ).astype(np.float32)
        return dict(embeds=jnp.asarray(e)), dict(embeds=torch.as_tensor(e))
    tok = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    return dict(tokens=jnp.asarray(tok)), dict(tokens=torch.as_tensor(tok))


def positions(batch=B, seq=S):
    p = np.broadcast_to(np.arange(seq, dtype=np.int32), (batch, seq))
    return jnp.asarray(p), torch.as_tensor(p.copy())


# ---------------------------------------------------------------------------
# functions
# ---------------------------------------------------------------------------


def _rng_arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def test_rmsnorm_and_layernorm():
    x, w, b = _rng_arrays(0, (3, 5, 48), (48,), (48,))
    got = port_common.rmsnorm(torch.as_tensor(x), torch.as_tensor(w), 1e-5)
    want = ref_common.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F_ATOL,
                               rtol=F_RTOL)
    got = port_common.layernorm(torch.as_tensor(x), torch.as_tensor(w),
                                torch.as_tensor(b), 1e-5)
    want = ref_common.layernorm(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F_ATOL,
                               rtol=F_RTOL)


def test_rmsnorm_bfloat16_casts_back():
    x, w = _rng_arrays(1, (4, 32), (32,))
    got = port_common.rmsnorm(torch.as_tensor(x).bfloat16(),
                              torch.as_tensor(w).bfloat16(), 1e-6)
    want = ref_common.rmsnorm(jnp.asarray(x).astype(jnp.bfloat16),
                              jnp.asarray(w).astype(jnp.bfloat16), 1e-6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=1e-2,
                               rtol=1e-2)


@pytest.mark.parametrize("hd", [16, 17, 128])
def test_rope_half_split(hd):
    """Half-split rotation; an odd head dim passes its last channel."""
    (x,) = _rng_arrays(hd, (2, 40, 3, hd))
    pos = np.broadcast_to(np.arange(100, 140, dtype=np.int32), (2, 40))
    got = port_common.rope(torch.as_tensor(x), torch.as_tensor(pos.copy()),
                           1e6)
    want = ref_common.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_padded_vocab():
    for arch in DENSE_ARCHS:
        assert (port_common.padded_vocab(get_config(arch))
                == ref_common.padded_vocab(ref_get_config(arch)))


def _carry(module, tree):
    for name, leaf in tree.items():
        module.get_parameter(name).data = torch.tensor(np.asarray(leaf))


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "gelu"])
def test_mlp_types(mlp_type):
    cfg = dataclasses.replace(ref_reduced(ref_get_config("qwen2-1.5b")),
                              mlp_type=mlp_type)
    pcfg = port_cfg("qwen2-1.5b", mlp_type=mlp_type)
    p = ref_common.init_params(jax.random.PRNGKey(3),
                               ref_mlp.mlp_template(cfg))
    if "bi" in p:     # non-zero biases, so that they are exercised
        p = dict(p, bi=p["bi"] + 0.1, bd=p["bd"] - 0.2)
    mod = port_mlp.MLP(pcfg, device="cpu", dtype=torch.float32)
    _carry(mod, np_tree(p))
    (x,) = _rng_arrays(4, (2, 7, cfg.d_model))
    got = mod(torch.as_tensor(x))
    want = ref_mlp.mlp_apply(p, jnp.asarray(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F_ATOL,
                               rtol=F_RTOL)


def test_qkv_proj_with_bias_and_out_proj():
    cfg = ref_reduced(ref_get_config("qwen2-1.5b"))
    pcfg = port_cfg("qwen2-1.5b")
    p = ref_common.init_params(jax.random.PRNGKey(5),
                               ref_attn.attn_template(cfg))
    p = dict(p, bq=p["bq"] + 0.3, bk=p["bk"] - 0.1, bv=p["bv"] + 0.2)
    mod = port_attn.Attention(pcfg, device="cpu", dtype=torch.float32)
    _carry(mod, np_tree(p))
    (x,) = _rng_arrays(6, (2, 9, cfg.d_model))
    jp, tp = positions(2, 9)
    got = port_attn.qkv_proj(mod, torch.as_tensor(x), pcfg, tp)
    want = ref_attn.qkv_proj(p, jnp.asarray(x), cfg, jp)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=F_ATOL,
                                   rtol=F_RTOL)
    o = got[0]
    np.testing.assert_allclose(
        port_attn.out_proj(mod, o).numpy(),
        np.asarray(ref_attn.out_proj(p, jnp.asarray(o.numpy()))),
        atol=F_ATOL, rtol=F_RTOL)


@pytest.mark.parametrize("window", [0, 5])
def test_naive_attention(window):
    q, k, v = _rng_arrays(8, (2, 12, 4, 16), (2, 12, 2, 16), (2, 12, 2, 16))
    jp, tp = positions(2, 12)
    got = port_attn.naive_attention(*map(torch.as_tensor, (q, k, v)), tp,
                                    tp, window)
    want = ref_attn.naive_attention(*map(jnp.asarray, (q, k, v)), jp, jp,
                                    window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F_ATOL,
                               rtol=F_RTOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_forward_matches_reference_jnp_path(arch):
    cfg, params = ref_model(arch)
    pcfg = port_cfg(arch)
    model = model_from_reference(pcfg, np_tree(params), "cpu")
    jin, tin = inputs(cfg)
    jp, tp = positions()
    want, _, _ = ref_tfm.forward(params, cfg, None, positions=jp,
                                 mode="train", **jin)
    got, _, aux = port_tfm.forward(model, positions=tp, mode="train", **tin)
    assert got.shape == (B, S, cfg.d_model) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=JNP_ATOL,
                               rtol=JNP_RTOL)


def test_forward_matches_reference_pallas_kernels():
    """One arch (interpret mode is slow): the reference with
    ``use_pallas_kernels=True`` routes attention through its flash
    kernel, in interpret mode on the CPU."""
    cfg, params = ref_model("qwen2-1.5b", use_pallas_kernels=True)
    model = model_from_reference(port_cfg("qwen2-1.5b"), np_tree(params),
                                 "cpu")
    jin, tin = inputs(cfg)
    jp, tp = positions()
    want, _, _ = ref_tfm.forward(params, cfg, None, positions=jp,
                                 mode="train", **jin)
    got, _, _ = port_tfm.forward(model, positions=tp, mode="train", **tin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=PALLAS_ATOL, rtol=PALLAS_RTOL)


def test_logits_tied_and_untied():
    for arch in ("qwen2-1.5b", "deepseek-7b"):     # tied, untied
        cfg, params = ref_model(arch)
        model = model_from_reference(port_cfg(arch), np_tree(params), "cpu")
        (h,) = _rng_arrays(9, (2, 3, cfg.d_model))
        got = port_tfm.logits_fn(model, torch.as_tensor(h))
        want = ref_tfm.logits_fn(params, jnp.asarray(h), cfg, None)
        assert got.shape[-1] == ref_common.padded_vocab(cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=F_ATOL, rtol=F_RTOL)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_weights_round_trip(param_dtype):
    """Every reference leaf lands, unstacked, on its layer, in its own
    dtype and bit for bit (bfloat16 through float32 is exact)."""
    cfg, params = ref_model("h2o-danube-3-4b", param_dtype=param_dtype)
    model = model_from_reference(port_cfg("h2o-danube-3-4b"),
                                 np_tree(params), "cpu")
    want_dtype = getattr(torch, param_dtype)
    leaves = jax.tree_util.tree_leaves_with_path(params)
    n_port = sum(1 for _ in model.parameters())
    n_ref = 0
    for path, leaf in leaves:
        keys = [p.key for p in path]
        a = np.asarray(leaf.astype(jnp.float32))
        if keys[0] == "groups":
            gi, bi = int(keys[1][1:]), int(keys[2][1:])
            _, kinds, reps, idx = port_tfm.group_layers(cfg)[gi]
            for r in range(reps):
                p = model.layers[idx[r][bi]].get_parameter(".".join(keys[3:]))
                assert p.dtype == want_dtype
                np.testing.assert_array_equal(p.float().numpy(),
                                              a[r] if reps > 1 else a)
                n_ref += 1
        else:
            p = model.get_parameter(".".join(keys))
            assert p.dtype == want_dtype
            np.testing.assert_array_equal(p.float().numpy(), a)
            n_ref += 1
    assert n_ref == n_port


def test_init_model_follows_the_reference_rules():
    """Seeded, and drawn under the rules of ``init_params``: zero norms
    and biases, embed at std 0.02, a stacked leaf's fan-in counts the
    layer axis."""
    cfg = port_cfg("qwen2-1.5b", n_layers=4, d_model=256, d_ff=512,
                   vocab_size=4096)
    a = port_tfm.init_model(cfg, torch.Generator().manual_seed(3), "cpu")
    b = port_tfm.init_model(cfg, torch.Generator().manual_seed(3), "cpu")
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    assert p.dtype == torch.float32
    blk = a.layers[0]
    assert not blk.ln1.w.any() and not blk.attn.bq.any()
    assert abs(float(a.embed.std()) - 0.02) < 0.001
    reps = cfg.n_layers
    want = 1 / np.sqrt(reps * cfg.d_model * cfg.n_heads)   # (L, D, Hq, hd)
    wq = torch.stack([layer.attn.wq for layer in a.layers])
    assert abs(float(wq.std()) / want - 1) < 0.02
    assert not torch.equal(a.layers[0].attn.wq, a.layers[1].attn.wq)


def test_init_tensor_scales_in_place_as_the_old_formula():
    """``z.mul_(std)`` then the cast: the values of ``(z * std).to``."""
    for init, dtype in [("normal", torch.bfloat16), ("small", torch.float32),
                        ("embed", torch.bfloat16)]:
        got = port_common.init_tensor((3, 40, 24), init, 0.5,
                                      torch.Generator().manual_seed(7), dtype)
        z = torch.randn((3, 40, 24), generator=torch.Generator().manual_seed(7),
                        dtype=torch.float32)
        std = dict(normal=0.5 / np.sqrt(120), small=0.02 * 0.5,
                   embed=0.5)[init]
        assert torch.equal(got, (z * std).to(dtype)), init


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "rwkv6-3b"])
def test_float32_init_rounded_through_bfloat16_is_the_bfloat16_init(arch):
    """A float32 model drawn from the same seed, each leaf rounded through
    bfloat16, holds the bfloat16 model's weights exactly (the card's
    float32 copy is made so, without the bfloat16 model resident)."""
    cfg = port_cfg(arch, param_dtype="bfloat16", dtype="bfloat16")
    cfg32 = port_cfg(arch)
    a = port_tfm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    b = port_tfm.init_model(cfg32, torch.Generator().manual_seed(0), "cpu")
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert p.dtype == torch.bfloat16 and q.dtype == torch.float32
        assert torch.equal(p.float(), q.bfloat16().float()), n


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_matches_reference_jnp_path(arch):
    """Hidden states and the summed aux loss; Kimi K2 with its dense
    ``attn_dense`` first layer. These replace the raise-tests of the
    MoE kinds, which were ported."""
    cfg, params = ref_model(arch)
    model = model_from_reference(port_cfg(arch), np_tree(params), "cpu")
    kinds = ["attn_dense"] * cfg.first_k_dense + ["attn"] * (
        cfg.n_layers - cfg.first_k_dense)
    assert [b.kind for b in model.layers] == kinds
    assert [type(b.mlp).__name__ for b in model.layers] == [
        "MLP" if k == "attn_dense" else "MoE" for k in kinds]
    jin, tin = inputs(cfg)
    jp, tp = positions()
    want, _, want_aux = ref_tfm.forward(params, cfg, None, positions=jp,
                                        mode="train", **jin)
    got, _, aux = port_tfm.forward(model, positions=tp, mode="train", **tin)
    assert float(aux) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=JNP_ATOL,
                               rtol=JNP_RTOL)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=F_ATOL,
                               rtol=F_RTOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_matches_reference_pallas_kernels(arch):
    cfg, params = ref_model(arch, use_pallas_kernels=True)
    model = model_from_reference(port_cfg(arch), np_tree(params), "cpu")
    jin, tin = inputs(cfg)
    jp, tp = positions()
    want, _, want_aux = ref_tfm.forward(params, cfg, None, positions=jp,
                                        mode="train", **jin)
    got, _, aux = port_tfm.forward(model, positions=tp, mode="train", **tin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=PALLAS_ATOL, rtol=PALLAS_RTOL)
    np.testing.assert_allclose(float(aux), float(want_aux),
                               atol=PALLAS_ATOL, rtol=PALLAS_RTOL)


def test_moe_weights_round_trip():
    """Kimi K2's bfloat16 leaves (a dense first group, an MoE group with
    a shared expert) land on their layers bit for bit."""
    cfg, params = ref_model("kimi-k2-1t-a32b", param_dtype="bfloat16")
    model = model_from_reference(port_cfg("kimi-k2-1t-a32b"),
                                 np_tree(params), "cpu")
    names = set()
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        keys = [p.key for p in path]
        if keys[0] != "groups":
            continue
        layer = port_tfm.group_layers(cfg)[int(keys[1][1:])][3][0][0]
        name = ".".join(keys[3:])
        p = model.layers[layer].get_parameter(name)
        assert p.dtype == torch.bfloat16
        np.testing.assert_array_equal(p.float().numpy(),
                                      np.asarray(leaf.astype(jnp.float32)))
        names.add((layer, name))
    assert {(1, "mlp.router"), (1, "mlp.wg"), (1, "mlp.shared.wd"),
            (0, "mlp.wg")} <= names and (0, "mlp.router") not in names
    assert len(names) == sum(1 for n, _ in model.named_parameters()
                             if n.startswith("layers."))


def test_long_sequence_takes_the_blocked_path():
    """S 1100 > 1024: both packages' models run ``blocked_attention``
    (the port's on CPU tensors only), and agree."""
    cfg, params = ref_model("qwen2-1.5b")
    model = model_from_reference(port_cfg("qwen2-1.5b"), np_tree(params),
                                 "cpu")
    jin, tin = inputs(cfg, batch=1, seq=1100)
    jp, tp = positions(1, 1100)
    want, _, _ = ref_tfm.forward(params, cfg, None, positions=jp,
                                 mode="train", **jin)
    calls = []
    blocked = port_attn.blocked_attention

    def counted(*a, **k):
        calls.append(a[0].shape)
        return blocked(*a, **k)

    port_attn.blocked_attention = counted
    try:
        got, _, _ = port_tfm.forward(model, positions=tp, mode="train",
                                     **tin)
    finally:
        port_attn.blocked_attention = blocked
    assert len(calls) == cfg.n_layers
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=JNP_ATOL,
                               rtol=JNP_RTOL)


def test_layer_groups_match_reference():
    from repro.configs import list_configs
    for arch in list_configs():
        if arch in ("vgg19-imagenet", "resnet101-tiny"):
            continue
        assert (port_tfm.layer_groups(get_config(arch))
                == ref_tfm.layer_groups(ref_get_config(arch))), arch


def test_param_counts_and_reduced_match_reference():
    from repro.configs import list_configs
    for arch in list_configs():
        rc, pc = ref_get_config(arch), get_config(arch)
        if rc.family == "cnn":
            continue
        assert pc.param_counts() == rc.param_counts(), arch
        assert (dataclasses.asdict(reduced(pc))
                == dataclasses.asdict(ref_reduced(rc))), arch
    assert get_config("qwen2-1.5b").param_counts()["total"] == 1_543_712_768


# ---------------------------------------------------------------------------
# recurrent layers: RG-LRU and RWKV6
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch, replace", RECURRENT, ids=RECURRENT_IDS)
def test_recurrent_forward_matches_reference_jnp_path(arch, replace):
    cfg, params = ref_model(arch, **replace)
    model = model_from_reference(port_cfg(arch, **replace), np_tree(params),
                                 "cpu")
    assert [b.kind for b in model.layers] == list(cfg.layer_kinds())
    jin, tin = inputs(cfg)
    jp, tp = positions()
    want, _, _ = ref_tfm.forward(params, cfg, None, positions=jp,
                                 mode="train", **jin)
    got, _, aux = port_tfm.forward(model, positions=tp, mode="train", **tin)
    assert got.shape == (B, S, cfg.d_model) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=JNP_ATOL,
                               rtol=JNP_RTOL)


@pytest.mark.parametrize("arch, replace", RECURRENT, ids=RECURRENT_IDS)
def test_recurrent_forward_matches_reference_pallas_kernels(arch, replace):
    """``use_pallas_kernels=True``: the reference's scans (and
    RecurrentGemma's flash attention) run their Pallas kernels in
    interpret mode."""
    cfg, params = ref_model(arch, use_pallas_kernels=True, **replace)
    model = model_from_reference(port_cfg(arch, **replace), np_tree(params),
                                 "cpu")
    jin, tin = inputs(cfg)
    jp, tp = positions()
    want, _, _ = ref_tfm.forward(params, cfg, None, positions=jp,
                                 mode="train", **jin)
    got, _, _ = port_tfm.forward(model, positions=tp, mode="train", **tin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=PALLAS_ATOL, rtol=PALLAS_RTOL)


@pytest.mark.parametrize("arch, replace", RECURRENT, ids=RECURRENT_IDS)
def test_recurrent_weights_round_trip(arch, replace):
    """Every bfloat16 reference leaf lands, unstacked, on its layer, bit
    for bit, under the reference's names."""
    cfg, params = ref_model(arch, param_dtype="bfloat16", **replace)
    model = model_from_reference(port_cfg(arch, **replace), np_tree(params),
                                 "cpu")
    n_ref = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        keys = [p.key for p in path]
        a = np.asarray(leaf.astype(jnp.float32))
        if keys[0] != "groups":
            continue
        gi, bi = int(keys[1][1:]), int(keys[2][1:])
        _, kinds, reps, idx = port_tfm.group_layers(cfg)[gi]
        for r in range(reps):
            p = model.layers[idx[r][bi]].get_parameter(".".join(keys[3:]))
            assert p.dtype == torch.bfloat16
            np.testing.assert_array_equal(p.float().numpy(),
                                          a[r] if reps > 1 else a)
            n_ref += 1
    n_port = sum(1 for n, _ in model.named_parameters()
                 if n.startswith("layers."))
    assert n_ref == n_port


def test_recurrent_init_follows_the_reference_rules():
    """``lam`` and ``gn_w`` ones, biases zero, ``small`` leaves at std
    0.02, projections at 1/sqrt(fan-in) with a stacked group's layer
    axis counted."""
    cfg = port_cfg("recurrentgemma-2b", n_layers=6, d_model=256,
                   lru_width=256, d_ff=512, vocab_size=1024)
    m = port_tfm.init_model(cfg, torch.Generator().manual_seed(5), "cpu")
    lru = m.layers[0].lru
    assert bool((lru.lam == 1).all()) and not lru.conv_b.any()
    assert not lru.ba.any() and not lru.bx.any()
    assert abs(float(lru.gate_a.std()) - 0.02) < 0.002
    reps = 2                                      # two cycles of 3 blocks
    wx = torch.stack([m.layers[i].lru.wx for i in (0, 3)])
    assert abs(float(wx.std()) * np.sqrt(reps * 256) - 1) < 0.05
    cfg = port_cfg("rwkv6-3b", n_layers=4, d_model=256, d_ff=512,
                   vocab_size=1024, rwkv_head_dim=32)
    m = port_tfm.init_model(cfg, torch.Generator().manual_seed(6), "cpu")
    mix = m.layers[1].mix
    assert bool((mix.gn_w == 1).all()) and not mix.gn_b.any()
    assert abs(float(mix.mu.std()) - 0.02) < 0.003
    wr = torch.stack([layer.mix.wr for layer in m.layers])  # (L, D, H, hd)
    want = 1 / np.sqrt(4 * 256 * 8)
    assert abs(float(wr.std()) / want - 1) < 0.02


def test_recurrent_cache_layout():
    """Per-layer state dicts in float32, as the reference's ``init_cache``
    keeps ``h``, ``conv``, ``s`` and the shifts; local layers get a ring of
    min(max_seq, window) slots."""
    for arch in ("recurrentgemma-2b", "rwkv6-3b"):
        pcfg = port_cfg(arch)
        cfg = ref_reduced(ref_get_config(arch))
        cache = port_tfm.init_cache(pcfg, 2, 40, dtype=torch.bfloat16,
                                    device="cpu")
        rc = ref_tfm.init_cache(cfg, 2, 40, dtype=jnp.bfloat16)
        for gi, _, reps, idx in port_tfm.group_layers(pcfg):
            g = rc["groups"][f"g{gi}"]
            for r, row in enumerate(idx):
                for i, li in enumerate(row):
                    want = g[f"b{i}"]
                    assert sorted(cache[li]) == sorted(want)
                    for name, t in cache[li].items():
                        w = np.asarray(want[name])
                        w = w[r] if reps > 1 else w
                        assert tuple(t.shape) == w.shape, (arch, name)
                        assert str(t.dtype).split(".")[-1] == str(w.dtype)
