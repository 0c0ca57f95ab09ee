"""The port's mesh layer on abstract meshes, against the reference's:
templates, rules, specs and optimizer state templates.

Every architecture's parameter template (``model_template``), cache
template (``cache_template`` at ``decode_32k`` and ``prefill_32k``) and
both optimizers' state templates equal the reference's leaf for leaf in
shape, axes, init rule and scale; ``build_rules`` gives the reference's
dict, and every leaf's spec equals the reference's ``ShardCtx.spec`` (a
``PartitionSpec``, compared as a tuple) on the same abstract mesh. The
divisibility and consistency checks of ``tests/test_sharding_rules.py``
hold on the port's own specs. Host only, no tensors."""
import numpy as np
import pytest
import torch

from repro.compat import abstract_mesh
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.distributed import sharding as rsh
from repro.models import transformer as rtfm
from repro.models.common import P as RefP
from repro.train import optimizer as ropt
from repro_torch.configs import SHAPES, get_config, list_configs, reduced
from repro_torch.distributed import sharding as sh
from repro_torch.models import transformer as tfm
from repro_torch.models.common import P, padded_vocab
from repro_torch.train import optimizer as opt

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
OPTIMIZERS = ("adamw", "adafactor")


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _as_tuples(tree, cls):
    out = {}
    for path, t in _leaves(tree):
        assert isinstance(t, cls), (path, t)
        out[path] = (tuple(t.shape), tuple(t.axes), t.init, t.scale)
    return out


def _optimizers(mod):
    lr = mod.cosine_schedule(1e-3, 0, 10)
    return {"adamw": mod.adamw(lr), "adafactor": mod.adafactor(lr)}


def _spec(spec):
    return tuple(spec)


@pytest.mark.parametrize("arch", list_configs())
def test_model_template_is_the_reference_s(arch):
    got = _as_tuples(tfm.model_template(get_config(arch)), P)
    want = _as_tuples(rtfm.model_template(ref_get_config(arch)), RefP)
    assert got == want


@pytest.mark.parametrize("arch", list_configs())
@pytest.mark.parametrize("shape_name", ["decode_32k", "prefill_32k"])
def test_cache_template_is_the_reference_s(arch, shape_name):
    shape, rshape = SHAPES[shape_name], REF_SHAPES[shape_name]
    assert (shape.global_batch, shape.seq_len) == (rshape.global_batch,
                                                   rshape.seq_len)
    got = _as_tuples(tfm.cache_template(get_config(arch), shape.global_batch,
                                        shape.seq_len), P)
    want = _as_tuples(rtfm.cache_template(ref_get_config(arch),
                                          rshape.global_batch,
                                          rshape.seq_len), RefP)
    assert got == want


@pytest.mark.parametrize("arch", list_configs())
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_state_template_is_the_reference_s(arch, name):
    cfg = get_config(arch)
    got = _optimizers(opt)[name].state_template(tfm.model_template(cfg))
    want = _optimizers(ropt)[name].state_template(
        rtfm.model_template(ref_get_config(arch)))
    assert _as_tuples(got, P) == _as_tuples(want, RefP)


def test_adafactor_factors_the_stacked_shapes():
    """A stack of vectors (reps, D) gets vr (reps,) and vc (D,)."""
    cfg = get_config("qwen2-1.5b")
    st = opt.adafactor(opt.cosine_schedule(1e-3, 0, 10)).state_template(
        tfm.model_template(cfg))
    ln = st["v"]["groups"]["g0"]["b0"]["ln1"]["w"]
    assert ln["vr"].shape == (cfg.n_layers,)
    assert ln["vc"].shape == (cfg.d_model,)
    assert st["step"].shape == ()


def _check_tree(tmpl, ctx, sizes, what, arch):
    for path, t in _leaves(tmpl):
        spec = ctx.spec(t.axes)
        for dim, ax in zip(t.shape, spec):
            if ax is None:
                continue
            axs = (ax,) if isinstance(ax, str) else tuple(ax)
            total = int(np.prod([sizes[a] for a in axs]))
            assert dim % total == 0, (
                f"{arch} {what} {path}: dim {dim} not divisible by "
                f"{axs}={total}")


def _same_specs(tmpl, ctx, rtmpl, rctx):
    got = {p: ctx.spec(t.axes) for p, t in _leaves(tmpl)}
    want = {p: _spec(rctx.spec(t.axes)) for p, t in _leaves(rtmpl)}
    assert got == want


@pytest.mark.parametrize("arch", list_configs())
@pytest.mark.parametrize("mesh_shape,axes", MESHES)
@pytest.mark.parametrize("fsdp", [False, True])
def test_param_and_state_specs_are_the_reference_s(arch, mesh_shape, axes,
                                                   fsdp):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    mesh = sh.AbstractMesh(mesh_shape, axes)
    rmesh = abstract_mesh(mesh_shape, axes)
    rules = sh.build_rules(cfg, mesh, fsdp=fsdp)
    rrules = rsh.build_rules(rcfg, rmesh, fsdp=fsdp)
    assert rules == rrules
    ctx = sh.ShardCtx(mesh=mesh, rules=rules)
    rctx = rsh.ShardCtx(mesh=rmesh, rules=rrules)
    assert ctx.axis_sizes == dict(zip(axes, mesh_shape))
    sizes = dict(zip(axes, mesh_shape))

    tmpl, rtmpl = tfm.model_template(cfg), rtfm.model_template(rcfg)
    _check_tree(tmpl, ctx, sizes, "params", arch)
    _same_specs(tmpl, ctx, rtmpl, rctx)
    assert _flat_specs(sh.spec_tree(tmpl, ctx)) == {
        p: _spec(s) for p, s in _leaves(rsh.spec_tree(rtmpl, rctx))}
    for name in OPTIMIZERS:
        st = _optimizers(opt)[name].state_template(tmpl)
        _check_tree(st, ctx, sizes, "opt", arch)
        _same_specs(st, ctx, _optimizers(ropt)[name].state_template(rtmpl),
                    rctx)
        assert _flat_specs(opt.opt_spec_tree(_optimizers(opt)[name], tmpl,
                                             ctx)) == _flat_specs(
            sh.spec_tree(st, ctx))


def _flat_specs(tree, prefix=()):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flat_specs(tree[k], prefix + (k,)))
        return out
    return {prefix: tuple(tree)}


@pytest.mark.parametrize("arch", list_configs())
@pytest.mark.parametrize("shape_name", ["decode_32k", "prefill_32k"])
def test_cache_specs_divisible_and_the_reference_s(arch, shape_name):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    shape = SHAPES[shape_name]
    mesh = sh.AbstractMesh((16, 16), ("data", "model"))
    rmesh = abstract_mesh((16, 16), ("data", "model"))
    ctx = sh.make_ctx(cfg, mesh)
    rctx = rsh.ShardCtx(mesh=rmesh, rules=rsh.build_rules(rcfg, rmesh))
    tmpl = tfm.cache_template(cfg, shape.global_batch, shape.seq_len)
    _check_tree(tmpl, ctx, dict(data=16, model=16), "cache", arch)
    _same_specs(tmpl, ctx, rtfm.cache_template(rcfg, shape.global_batch,
                                               shape.seq_len), rctx)


@pytest.mark.parametrize("arch", list_configs())
def test_rules_consistent(arch):
    cfg = get_config(arch)
    mesh = sh.AbstractMesh((16, 16), ("data", "model"))
    rules = sh.build_rules(cfg, mesh)
    # padded vocab divisible by model
    assert padded_vocab(cfg) % 16 == 0
    # kv_seq sharded exactly when kv heads are not
    assert (rules["kv_heads"] == "model") == (rules["kv_seq"] is None)


def test_local_ctx_and_sharding_tree():
    """``local_ctx`` is the reference's one-device context; a sharding
    tree holds one placement a mesh axis (``Shard(dim)`` where a dim
    maps to it)."""
    from torch.distributed.tensor import Replicate, Shard

    cfg = reduced(get_config("qwen2-1.5b"))
    ctx = sh.local_ctx(cfg)
    assert ctx.axis_sizes == dict(data=1, model=1)
    assert ctx.rules == rsh.build_rules(
        ref_reduced(ref_get_config("qwen2-1.5b")),
        abstract_mesh((1, 1), ("data", "model")))
    assert sh.local_ctx().rules == {}
    moe = get_config("qwen2-moe-a2.7b")       # 16 heads over 16
    big = sh.make_ctx(moe, sh.AbstractMesh((16, 16), ("data", "model")))
    tree = sh.sharding_tree(tfm.model_template(moe), big)
    assert tree["embed"] == (Replicate(), Shard(0))
    wq = tree["groups"]["g0"]["b0"]["attn"]["wq"]
    assert wq == (Replicate(), Shard(2))      # (layers, embed, heads, hd)


def test_local_slices_and_shapes():
    """``ShardCtx.local`` cuts each sharded dim into equal contiguous
    parts, the rank taking its part; tuples of axes combine row-major."""
    cfg = get_config("qwen2-1.5b")
    mesh = sh.AbstractMesh((2, 2, 4), ("pod", "data", "model"), (1, 0, 3))
    ctx = sh.make_ctx(cfg, mesh)
    assert ctx.spec(("batch", "vocab")) == (("pod", "data"), "model")
    t = torch.arange(8 * 8).reshape(8, 8)
    loc = ctx.local(t, ("batch", "vocab"))
    assert loc.shape == ctx.local_shape((8, 8), ("batch", "vocab")) == (2, 2)
    # batch index pod 1, data 0 -> part 2 of 4; vocab part 3 of 4
    assert torch.equal(loc, t[4:6, 6:8])
    with pytest.raises(ValueError):
        ctx.local_shape((6, 8), ("batch", None))
    assert sh.scenario_mesh().axis_names == ("scen",)
