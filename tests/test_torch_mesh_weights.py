"""Weights per rank and the decode kernel's log-sum-exp, on the CPU.

``interop.model_from_reference(cfg, params, device, ctx)`` gives each rank
its shards of the reference's parameters, and ``init_model(...,
ctx=ctx)`` each rank its shards of the seeded draws: put back together
over the ranks of a (2, 2) and a (1, 4) mesh they equal the unsharded
model's parameters bit for bit. ``interop.param_map`` and ``cache_map``
cover every leaf of the reference's templates once.

``decode_attention``'s plain version with ``return_lse`` gives the output
of the reference's ``ref.py`` and each row's log-sum-exp (against a
float64 evaluation), and two slices of a cache, each attended with its
log-sum-exp, merge to the whole (``ref.merge_lse``); the plain emulation
of the kernel's splits gives the same log-sum-exp."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ref import decode_attention_ref as rref
from repro.models import transformer as rtfm
from repro_torch import interop
from repro_torch.configs import get_config, reduced
from repro_torch.distributed import sharding as sh
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_split_ref, merge_lse)
from repro_torch.models import transformer as tfm

torch.set_num_threads(1)
ARCHS = ("qwen2-1.5b", "recurrentgemma-2b", "rwkv6-3b", "qwen2-moe-a2.7b")
MESHES = ((2, 2), (1, 4))
LSE_ATOL = 1e-5       # float32 log-sum-exp of scores of magnitude < 10


def _cfg(arch, mode=None):
    cfg = reduced(get_config(arch))
    return dataclasses.replace(cfg, moe_sharding=mode) if mode else cfg


def _ctxs(cfg, shape):
    return [sh.make_ctx(cfg, sh.AbstractMesh(shape, ("data", "model"),
                                             (d, m)))
            for d in range(shape[0]) for m in range(shape[1])]


def _put_together(cfg, ctxs, models):
    """Each parameter of the ranks' models placed at its rank's offsets
    in a whole (NaN-filled) tensor."""
    out = {}
    for name, p in models[0].named_parameters():
        whole = torch.full(p.full_shape, float("nan"), dtype=p.dtype)
        for ctx, model in zip(ctxs, models):
            ctx.local(whole, p.axes).copy_(model.get_parameter(name))
        out[name] = whole
    return out


CASES = [(a, None, s) for a in ARCHS for s in MESHES] + [
    ("qwen2-moe-a2.7b", "expert", s) for s in MESHES]


@pytest.mark.parametrize("arch,mode,shape", CASES)
def test_model_from_reference_shards_put_together_are_the_model(arch, mode,
                                                                shape):
    cfg = _cfg(arch, mode)
    np_params = jax.tree.map(np.asarray, rtfm.init_model(
        jax.random.PRNGKey(0), cfg))
    full = interop.model_from_reference(cfg, np_params, "cpu")
    ctxs = _ctxs(cfg, shape)
    models = [interop.model_from_reference(cfg, np_params, "cpu", ctx)
              for ctx in ctxs]
    got = _put_together(cfg, ctxs, models)
    for name, p in full.named_parameters():
        assert got[name].dtype == p.dtype
        assert torch.equal(got[name], p), name


@pytest.mark.parametrize("arch,mode,shape", CASES)
def test_seeded_init_shards_put_together_are_the_model(arch, mode, shape):
    cfg = _cfg(arch, mode)
    full = tfm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    ctxs = _ctxs(cfg, shape)
    models = [tfm.init_model(cfg, torch.Generator().manual_seed(0), "cpu",
                             ctx=ctx) for ctx in ctxs]
    got = _put_together(cfg, ctxs, models)
    for name, p in full.named_parameters():
        assert torch.equal(got[name], p), name
    # a rank holds its shard only: the vocab rows split over model
    assert models[0].embed.shape[0] == full.embed.shape[0] // shape[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_maps_cover_the_reference_templates_once(arch):
    cfg = _cfg(arch)
    leaves = jax.tree_util.tree_flatten_with_path(
        rtfm.model_template(cfg), is_leaf=lambda x: hasattr(x, "axes"))[0]
    paths = {tuple(k.key for k in path) for path, _ in leaves}
    pm = interop.param_map(cfg)
    assert {p for p, _, _ in pm} == paths
    model = tfm.Transformer(cfg, "cpu")
    assert sorted(n for _, _, n in pm) == sorted(
        n for n, _ in model.named_parameters())
    ct = jax.tree_util.tree_flatten_with_path(
        rtfm.cache_template(cfg, 2, 16),
        is_leaf=lambda x: hasattr(x, "axes"))[0]
    cm = interop.cache_map(cfg)
    assert {p for p, _, _, _ in cm} == {tuple(k.key for k in path)
                                        for path, _ in ct}
    cache = tfm.init_cache(cfg, 2, 16, torch.float32, "cpu")
    assert sorted((li, k) for _, _, li, k in cm) == sorted(
        (li, k) for li, layer in enumerate(cache) for k in layer)


def _decode_inputs(B, T, Hq, Hkv, hd, seed, empty_row=False):
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.normal(size=(B, Hq, hd)), dtype=torch.float32)
    k = torch.as_tensor(rng.normal(size=(B, T, Hkv, hd)), dtype=torch.float32)
    v = torch.as_tensor(rng.normal(size=(B, T, Hkv, hd)), dtype=torch.float32)
    kv_pos = torch.as_tensor(rng.permutation(T)[None].repeat(B, 0),
                             dtype=torch.int32)
    q_pos = torch.full((B,), T * 3 // 4, dtype=torch.int32)
    if empty_row:
        q_pos[0] = -1
    return q, k, v, kv_pos, q_pos


@pytest.mark.parametrize("window", [0, 24])
def test_decode_lse_plain_is_the_reference_s_and_merges(window):
    q, k, v, kv_pos, q_pos = _decode_inputs(2, 64, 6, 2, 16, seed=1)
    o, lse = decode_attention(q, k, v, kv_pos, q_pos, window=window,
                              return_lse=True)
    assert o.device.type == "cpu" and lse.shape == (2, 6)
    assert lse.dtype == torch.float32
    assert torch.equal(o, decode_attention(q, k, v, kv_pos, q_pos,
                                           window=window))
    want = rref(*(jax.numpy.asarray(t.numpy()) for t in
                  (q, k, v, kv_pos, q_pos)), window=window)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), atol=2e-6,
                               rtol=1e-5)
    # float64 log-sum-exp of the scaled, masked scores
    s = np.einsum("bhgd,bthd->bhgt",
                  q.double().numpy().reshape(2, 2, 3, 16),
                  k.double().numpy()) / np.sqrt(16)
    kp, qp = kv_pos.numpy()[:, None, None, :], q_pos.numpy()[:, None, None,
                                                             None]
    ok = kp <= qp
    if window:
        ok &= qp - kp < window
    s = np.where(ok, s, -np.inf)
    top = s.max(-1, keepdims=True)
    lse64 = (top + np.log(np.exp(s - top).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), lse64.reshape(2, 6),
                               atol=LSE_ATOL, rtol=0)
    # two halves of the cache, merged by their log-sum-exp
    parts = [decode_attention(q, k[:, sl], v[:, sl], kv_pos[:, sl].contiguous(),
                              q_pos, window=window, return_lse=True)
             for sl in (slice(0, 32), slice(32, 64))]
    merged = merge_lse(torch.stack([p[0] for p in parts]),
                       torch.stack([p[1] for p in parts]))
    np.testing.assert_allclose(merged.numpy(), o.numpy(), atol=2e-6,
                               rtol=1e-5)
    # the kernel's split emulation gives the same log-sum-exp
    _, lse_split = decode_attention_split_ref(
        q, k, v, kv_pos, q_pos, window=window, n_split=2,
        return_lse=True)
    np.testing.assert_allclose(lse_split.numpy(), lse.numpy(),
                               atol=LSE_ATOL, rtol=0)


def test_decode_lse_of_a_slice_with_no_allowed_slot_weighs_nothing():
    """A slice where a row's positions are all in the future scores
    -1e30: merged, it adds nothing to the slice that holds the token."""
    q, k, v, kv_pos, q_pos = _decode_inputs(1, 64, 4, 4, 16, seed=2)
    kv_pos = torch.arange(64, dtype=torch.int32)[None]
    q_pos = torch.tensor([20], dtype=torch.int32)
    o = decode_attention(q, k, v, kv_pos, q_pos)
    parts = [decode_attention(q, k[:, sl], v[:, sl],
                              kv_pos[:, sl].contiguous(), q_pos,
                              return_lse=True)
             for sl in (slice(0, 32), slice(32, 64))]
    assert float(parts[1][1].max()) < -1e29
    merged = merge_lse(torch.stack([p[0] for p in parts]),
                       torch.stack([p[1] for p in parts]))
    np.testing.assert_allclose(merged.numpy(), o.numpy(), atol=2e-6,
                               rtol=1e-5)
