"""The port's training step against the reference's on the CPU.

``repro_torch.train.trainer.loss_fn`` and its gradients against
``jax.value_and_grad`` of ``repro.train.trainer.loss_fn`` (``ctx=None``),
leaf by leaf through ``interop.params_to_reference``, on reduced float32
Qwen2-1.5B, Qwen1.5-MoE-A2.7B (its aux loss included), RecurrentGemma-2B,
RWKV6-3B and MusicGen (an ``embeds`` batch); ``make_train_step`` with 1
and 2 microbatches against the reference's over 3 AdamW steps; remat on
equal to remat off bit for bit; ``params_to_reference`` the inverse of
``model_from_reference``; and ``repro_torch.launch.train`` on the CPU
mirroring ``tests/test_integration.py``'s two training cases. The
reference's parameters are carried across, the batches come from the
same numpy-seeded pipeline.

Tolerances: the loss within rtol 1e-5 (float32 sums in another order);
each gradient leaf within 1e-4 of its largest magnitude plus 1e-7; after
each of 3 AdamW steps (lr 1e-2) the loss within 1e-5 (the check that
the steps agree), all but one element in a thousand of the parameters
within 1e-3 lr, and every element within 0.05 lr: Adam's first steps
take g / (|g| + eps) per element, so where a gradient element is within
float32 noise of 0 (3e-9 against a leaf's largest 3e-2, in ``mlp.wg``)
the two packages' last bits move it by a share of lr. Measured: at most
0.0125 lr, and 2.2e-4 of the elements beyond 1e-3 lr, by step 3 (a sign
flip would be 2 lr)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.data import SyntheticTokenPipeline
from repro.models import transformer as ref_tfm
from repro.train import optimizer as ref_opt
from repro.train import trainer as ref_trainer
from repro_torch.configs import get_config, reduced
from repro_torch.interop import model_from_reference, params_to_reference
from repro_torch.launch import train as train_mod
from repro_torch.models import transformer as port_tfm
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import trainer

torch.set_num_threads(1)
B, S = 2, 16
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
LR = 1e-2
STEP_ATOL = 1e-3 * LR               # all but STEP_SHARE of the elements
STEP_SHARE = 1e-3
STEP_ATOL_ALL = 0.05 * LR           # every element
ARCHS = ["qwen2-1.5b", "qwen2-moe-a2.7b", "recurrentgemma-2b", "rwkv6-3b",
         "musicgen-large"]


def _configs(arch, **replace):
    ref_cfg = dataclasses.replace(ref_reduced(ref_get_config(arch)),
                                  **replace)
    cfg = dataclasses.replace(reduced(get_config(arch)), **replace)
    return ref_cfg, cfg


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    """One parameter tree for both packages, in the reference's layout:
    drawn by the port's ``init_model`` (the reference's init rules; a
    torch draw takes milliseconds where JAX's eager draw takes seconds)
    and carried across by ``params_to_reference``."""
    _, cfg = _configs(arch)
    model = port_tfm.init_model(cfg, torch.Generator().manual_seed(1), "cpu")
    return params_to_reference(model, cfg)


def _compiled(fn, *args):
    """``fn`` compiled for ``args`` without XLA's costly backend passes:
    the reference's gradient programs compile in half the time."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})


def _batch(cfg, step=0, batch=B):
    """numpy: tokens (batch, S+1) from the synthetic pipeline, or embeds
    and labels for a frontend config."""
    toks = SyntheticTokenPipeline(cfg.vocab_size, batch, S, seed=3
                                  ).batch_at(step)["tokens"]
    if cfg.frontend is None:
        return dict(tokens=toks)
    rng = np.random.default_rng(step)
    return dict(embeds=rng.standard_normal((batch, S, cfg.d_model))
                .astype(np.float32), labels=toks[:, 1:])


def _torch_batch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _assert_grads(port_tree, ref_tree, path=""):
    if isinstance(ref_tree, dict):
        assert sorted(port_tree) == sorted(ref_tree), path
        for k in ref_tree:
            _assert_grads(port_tree[k], ref_tree[k], f"{path}/{k}")
        return
    ref = np.asarray(ref_tree)
    assert port_tree.shape == ref.shape, path
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(port_tree, ref, rtol=0,
                               atol=GRAD_RTOL * scale + GRAD_ATOL,
                               err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    ref_cfg, cfg = _configs(arch)
    params = _ref_params(arch)
    batch = _batch(cfg)

    def ref_loss(p, b):
        return ref_trainer.loss_fn(p, b, ref_cfg, None)

    args = (jax.tree.map(jnp.asarray, params),
            jax.tree.map(jnp.asarray, batch))
    (rl, rparts), rg = _compiled(jax.value_and_grad(ref_loss, has_aux=True),
                                 *args)(*args)
    model = model_from_reference(cfg, params, "cpu")
    (loss, parts), grads = trainer.value_and_grad(model, _torch_batch(batch),
                                                  cfg)
    np.testing.assert_allclose(float(loss), float(rl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts["aux"]), float(rparts["aux"]),
                               rtol=LOSS_RTOL, atol=1e-7)
    if cfg.moe:
        assert float(parts["aux"]) > 0
    _assert_grads(params_to_reference(model, cfg, grads),
                  jax.tree.map(np.asarray, rg))


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "recurrentgemma-2b",
                                  "rwkv6-3b"])
def test_params_to_reference_inverts_model_from_reference(arch):
    """The reference's tree (structure, shapes, dtypes: ``init_model``'s
    abstract output), and back through ``model_from_reference`` bit for
    bit."""
    ref_cfg, cfg = _configs(arch)
    params = _ref_params(arch)
    shapes = jax.eval_shape(lambda key: ref_tfm.init_model(key, ref_cfg),
                            jax.random.PRNGKey(0))
    assert jax.tree.structure(params) == jax.tree.structure(shapes)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(shapes)):
        assert a.shape == b.shape and a.dtype == b.dtype
    back = params_to_reference(model_from_reference(cfg, params, "cpu"),
                               cfg)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_reference(microbatches):
    """Three AdamW steps of ``make_train_step`` on reduced Qwen2-1.5B,
    batch 4, through 1 or 2 microbatches."""
    arch = "qwen2-1.5b"
    ref_cfg, cfg = _configs(arch)
    params = _ref_params(arch)
    sched = (2, 10)
    ref_o = ref_opt.adamw(ref_opt.cosine_schedule(LR, *sched))
    rp = jax.tree.map(jnp.asarray, params)
    rs = ref_o.init(rp)
    step = _compiled(ref_trainer.make_train_step(ref_cfg, None, ref_o,
                                                 microbatches), rp, rs,
                     jax.tree.map(jnp.asarray, _batch(cfg, 0, batch=4)))
    port_o = opt_mod.adamw(opt_mod.cosine_schedule(LR, *sched))
    model = model_from_reference(cfg, params, "cpu")
    ps = port_o.init(trainer.trainable_params(model))
    port_step = trainer.make_train_step(cfg, None, port_o, microbatches)
    for i in range(3):
        batch = _batch(cfg, i, batch=4)
        rp, rs, rm = step(rp, rs, jax.tree.map(jnp.asarray, batch))
        model, ps, pm = port_step(model, ps, _torch_batch(batch))
        np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(float(pm["gnorm"]), float(rm["gnorm"]),
                                   rtol=1e-4)
        got = np.concatenate([a.ravel() for a in jax.tree.leaves(
            params_to_reference(model, cfg))])
        want = np.concatenate([np.asarray(b).ravel()
                               for b in jax.tree.leaves(rp)])
        diff = np.abs(got - want)
        assert diff.max() <= STEP_ATOL_ALL, (i, diff.max())
        assert np.mean(diff > STEP_ATOL) <= STEP_SHARE, (i, np.mean(
            diff > STEP_ATOL))
    assert int(ps["step"]) == 3


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen2-moe-a2.7b"])
def test_remat_equals_no_remat_bit_for_bit(arch):
    _, cfg = _configs(arch)
    params = _ref_params(arch)
    batch = _torch_batch(_batch(cfg))
    out = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        model = model_from_reference(c, params, "cpu")
        out.append(trainer.value_and_grad(model, batch, c))
    (l0, _), g0 = out[0]
    (l1, _), g1 = out[1]
    assert torch.equal(l0, l1)
    assert sorted(g0) == sorted(g1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_training_reduces_loss_end_to_end(tmp_path):
    """Mirror of ``tests/test_integration.py``'s case, on the CPU."""
    losses = train_mod.main([
        "--arch", "qwen2-1.5b", "--reduced", "--steps", "40",
        "--batch", "8", "--seq", "32", "--lr", "3e-3", "--device", "cpu",
        "--ckpt", str(tmp_path / "ckpt")])
    assert losses[-1] < losses[0] - 0.1, (losses[0], losses[-1])


def test_grad_compression_training_still_converges(tmp_path):
    """Mirror of ``tests/test_integration.py``'s case, on the CPU; then a
    resumed run with nothing left to do."""
    argv = ["--arch", "qwen2-1.5b", "--reduced", "--steps", "30",
            "--batch", "8", "--seq", "32", "--lr", "3e-3",
            "--compress-grads", "--device", "cpu",
            "--ckpt", str(tmp_path / "ckpt")]
    losses = train_mod.main(argv)
    assert losses[-1] < losses[0] - 0.05
    assert train_mod.main(argv) == []


def test_bf16_training_follows_the_reference():
    """bf16 parameters, remat and 2 microbatches, as the card trains
    Qwen2-1.5B, at reduced width: 10 AdamW steps from the same weights on
    the same batches give the reference's loss at every step within 2e-3
    (bf16 rounds the two packages' sums at other places)."""
    rep = dict(dtype="bfloat16", param_dtype="bfloat16", remat=True)
    ref_cfg, cfg = _configs("qwen2-1.5b", **rep)
    model = port_tfm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    params = params_to_reference(model, cfg)
    ref_o = ref_opt.adamw(ref_opt.cosine_schedule(1e-3, 2, 10))
    rp = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), params)
    rs = ref_o.init(rp)
    batches = [_batch(cfg, i, batch=4) for i in range(10)]
    step = _compiled(ref_trainer.make_train_step(ref_cfg, None, ref_o, 2),
                     rp, rs, jax.tree.map(jnp.asarray, batches[0]))
    port_o = opt_mod.adamw(opt_mod.cosine_schedule(1e-3, 2, 10))
    ps = port_o.init(trainer.trainable_params(model))
    port_step = trainer.make_train_step(cfg, None, port_o, 2)
    for b in batches:
        rp, rs, rm = step(rp, rs, jax.tree.map(jnp.asarray, b))
        model, ps, pm = port_step(model, ps, _torch_batch(b))
        assert model.embed.dtype == torch.bfloat16
        np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                                   rtol=0, atol=2e-3)
