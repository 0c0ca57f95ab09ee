"""Training the MoE in the port against the reference on the CPU: the
capacity dispatch's gradients (``repro_torch.models.moe``, whose gather
into the capacity buffer has a backward of its own, ``_Dispatch``, that
adds a token's slot gradients in order and with no atomics), the
optimizers' leaf-by-leaf global-norm clip, three Adafactor steps of the
reduced Qwen1.5-MoE-A2.7B through ``make_train_step``, and
``launch.train --optimizer adafactor``. Numpy-seeded inputs feed both
packages; the reference's parameters are carried across.

Tolerances: the dispatch's gradients against ``jax.grad`` of the
reference's ``moe_apply`` within 1e-5 of each leaf's largest magnitude
plus 1e-7 (float32, the same operations summed in another order);
``_Dispatch``'s backward against autograd's backward of the plain gather
within 1e-12 (float64: one sum of k rows in another order); the clip
leaf by leaf equal to the tree clip bit for bit (the same operations on
the same elements); after each of three Adafactor steps the loss within
1e-5, all but one element in a thousand of the parameters within 1e-3
lr and every element within 0.05 lr of the reference's, the bars of
``tests/test_torch_train.py``'s AdamW steps: the attention's key bias
has a gradient of float32 noise only (softmax ignores a shift shared by
all keys), and Adafactor, as Adam, scales a leaf's update to an RMS of
about 1, so the two packages' noise moves it by a share of lr. Measured:
every other leaf within 5e-5 lr; the key bias 0.035 lr, 14 of the
534,080 parameter elements beyond 1e-3 lr."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.data import SyntheticTokenPipeline
from repro.models import moe as ref_moe
from repro.train import optimizer as ref_opt
from repro.train import trainer as ref_trainer
from repro_torch.configs import get_config, reduced
from repro_torch.interop import model_from_reference, params_to_reference
from repro_torch.launch import train as train_mod
from repro_torch.models import moe as port_moe
from repro_torch.models import transformer as port_tfm
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import trainer
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)
ARCH = "qwen2-moe-a2.7b"
B, S = 2, 64
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-7
DISPATCH_TOL = 1e-12
LR = 1e-2
STEP_ATOL = 1e-3 * LR               # all but STEP_SHARE of the elements
STEP_SHARE = 1e-3
STEP_ATOL_ALL = 0.05 * LR           # every element
AUX_COEF = 0.01


def configs(**replace):
    return (dataclasses.replace(ref_reduced(ref_get_config(ARCH)), **replace),
            dataclasses.replace(reduced(get_config(ARCH)), **replace))


@pytest.fixture(scope="module")
def moe_params():
    """The MoE leaves of the reduced model's first layer (8 experts,
    top-2, one shared expert) in the reference's layout, numpy: drawn by
    the port's ``init_model`` under the reference's rules (a torch draw
    takes milliseconds where JAX's eager draw takes seconds)."""
    _, cfg = configs()
    model = port_tfm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    tree = params_to_reference(model, cfg)["groups"]["g0"]["b0"]["mlp"]
    return jax.tree.map(lambda a: np.ascontiguousarray(a[0]), tree)


def port_layer(pcfg, p):
    mod = port_moe.MoE(pcfg, device="cpu", dtype=torch.float32)
    for path, leaf in jax.tree_util.tree_leaves_with_path(p):
        key = ".".join(k.key for k in path)
        mod.get_parameter(key).data = torch.tensor(leaf)
    return mod


@pytest.mark.parametrize("capacity_factor", [0.5, 4.0])
def test_capacity_dispatch_grads_match_reference(moe_params,
                                                 capacity_factor):
    """Gradients of sum(out * r) + 0.01 aux with respect to x, the
    router, wg, wu, wd and the shared expert's leaves; at capacity factor
    0.5 most experts overflow (drops), at 4.0 nothing drops."""
    cfg, pcfg = configs(capacity_factor=capacity_factor)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)

    def ref_loss(p, x_):
        out, aux = ref_moe.moe_apply(p, x_, cfg, None)
        return jnp.sum(out * r) + AUX_COEF * aux

    args = (jax.tree.map(jnp.asarray, moe_params), jnp.asarray(x))
    rg, rdx = _compiled(jax.grad(ref_loss, argnums=(0, 1)), *args)(*args)
    mod = port_layer(pcfg, moe_params)
    mod.requires_grad_(True)
    tx = torch.tensor(x, requires_grad=True)
    out, aux = port_moe.moe_apply(mod, tx, pcfg)
    names = [n for n, _ in mod.named_parameters()]
    grads = torch.autograd.grad(
        torch.sum(out * torch.tensor(r)) + AUX_COEF * aux,
        [tx] + [mod.get_parameter(n) for n in names])
    want = {".".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(rg)}
    want["x"] = np.asarray(rdx)
    got = dict(zip(["x"] + names, grads))
    assert sorted(got) == sorted(want)
    assert {"x", "router", "wg", "wu", "wd"} <= set(got)
    assert any(k.startswith("shared.") for k in got)
    for k, w in want.items():
        scale = float(np.abs(w).max())
        assert scale > 0, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * scale + GRAD_ATOL,
                                   err_msg=k)


class PlainDispatch:
    """The gather ``_Dispatch`` replaces, under autograd's own backward."""

    @staticmethod
    def apply(xt, src_t, filled, keep, slot, k):
        return torch.where(filled[..., None], xt[src_t], 0)


def _dispatch_grads(T=96, D=12, Fd=10, E=6, k=3, C=20, seed=0):
    """Gradients of the capacity dispatch (x, routing weights, wg, wu, wd)
    in float64, at a capacity that drops assignments."""
    rng = np.random.default_rng(seed)
    cfg = dataclasses.replace(reduced(get_config(ARCH)), top_k=k,
                              n_experts=E)
    topi = torch.as_tensor(np.argsort(rng.random((T, E)), axis=1)[:, :k])
    assert int(torch.bincount(topi.reshape(-1), minlength=E).max()) > C
    leaves = dict(
        x=rng.standard_normal((T, D)), w=rng.random((T, k)),
        wg=rng.standard_normal((E, D, Fd)), wu=rng.standard_normal((E, D, Fd)),
        wd=rng.standard_normal((E, Fd, D)))
    leaves = {n: torch.tensor(v, dtype=torch.float64, requires_grad=True)
              for n, v in leaves.items()}
    out = port_moe._dispatch_ffn_capacity(
        leaves["x"], leaves["w"], topi, leaves["wg"], leaves["wu"],
        leaves["wd"], cfg, 0, E, C)
    cot = torch.as_tensor(rng.standard_normal(out.shape))
    return out, dict(zip(leaves, torch.autograd.grad(
        torch.sum(out * cot), list(leaves.values()))))


def test_dispatch_backward_matches_the_plain_gather(monkeypatch):
    """``_Dispatch`` against autograd through the plain gather, float64,
    with drops: the same buffer and every gradient within 1e-12; two
    calls bit for bit."""
    out, got = _dispatch_grads()
    again_out, again = _dispatch_grads()
    assert torch.equal(out, again_out)
    for n in got:
        assert torch.equal(got[n], again[n]), n
    monkeypatch.setattr(port_moe, "_Dispatch", PlainDispatch)
    want_out, want = _dispatch_grads()
    assert torch.equal(out, want_out)
    for n in want:
        scale = float(want[n].abs().max())
        assert scale > 0, n
        torch.testing.assert_close(got[n], want[n], rtol=0,
                                   atol=DISPATCH_TOL * scale)


def test_dispatch_function_forward_is_the_gather_bit_for_bit(monkeypatch):
    """bf16, drops included: ``_Dispatch``'s buffer equals the plain
    gather's, and its backward gives each token the in-order sum of its
    kept slots' gradients."""
    rng = np.random.default_rng(3)
    T, D, E, k, C = 40, 8, 5, 3, 15
    cfg = dataclasses.replace(reduced(get_config(ARCH)), top_k=k,
                              n_experts=E)
    topi = torch.as_tensor(np.argsort(rng.random((T, E)), axis=1)[:, :k])
    xt = torch.tensor(rng.standard_normal((T, D)), dtype=torch.bfloat16)
    seen = {}
    dispatch = port_moe._Dispatch

    class Spy:
        @staticmethod
        def apply(xt_, src_t, filled, keep, slot, k_):
            seen.update(src_t=src_t, filled=filled, keep=keep, slot=slot)
            return dispatch.apply(xt_, src_t, filled, keep, slot, k_)

    monkeypatch.setattr(port_moe, "_Dispatch", Spy)
    monkeypatch.setattr(port_moe, "_expert_ffn", lambda xb, *a: xb)
    port_moe._dispatch_ffn_capacity(xt, torch.ones(T, k), topi, None, None,
                                    None, cfg, 0, E, C)
    monkeypatch.undo()
    leaf = xt.clone().requires_grad_(True)
    xb = port_moe._Dispatch.apply(leaf, seen["src_t"], seen["filled"],
                                  seen["keep"], seen["slot"], k)
    assert torch.equal(xb, PlainDispatch.apply(xt, seen["src_t"],
                                               seen["filled"], None, None, k))
    dxb = torch.tensor(rng.standard_normal(xb.shape), dtype=torch.bfloat16)
    (dx,) = torch.autograd.grad(xb, leaf, dxb)
    flat = dxb.reshape(-1, D)
    for t in range(T):
        want = torch.zeros(D, dtype=torch.bfloat16)
        for j in range(k):
            a = t * k + j
            if seen["keep"][a]:
                want = want + flat[seen["slot"][a]]
        assert torch.equal(dx[t], want), t
    assert not bool(seen["keep"].all())


def _clip_inputs(seed=0):
    """A float32 and a bf16 leaf of each kind (factored and not), with
    gradients whose global norm is past 1, so the clip scales them."""
    rng = np.random.default_rng(seed)
    params, grads = {}, {}
    for name, shape, dt in (("a", (6, 5), torch.float32),
                            ("b", (7,), torch.float32),
                            ("c", (4, 3, 8), torch.bfloat16),
                            ("d", (9,), torch.bfloat16)):
        params[name] = torch.tensor(rng.standard_normal(shape), dtype=dt)
        grads[name] = torch.tensor(rng.standard_normal(shape) * 3, dtype=dt)
    return params, grads


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_leaf_by_leaf_clip_equals_the_tree_clip(name):
    """Three updates with the clip taken inside the loop against the same
    updates fed the tree ``clip_by_global_norm`` made (and no clip of
    their own): parameters and state bit for bit."""
    make = getattr(opt_mod, name)
    sched = opt_mod.cosine_schedule(0.05, 2, 10)
    leafwise, tree = make(sched), make(sched, max_grad_norm=float("inf"))
    pa, _ = _clip_inputs()
    pb = {k: v.clone() for k, v in pa.items()}
    sa, sb = leafwise.init(pa), tree.init(pb)
    for step in range(3):
        _, g = _clip_inputs(step + 1)
        clipped, gn = opt_mod.clip_by_global_norm(g, 1.0)
        assert float(gn) > 1.0
        _, _, ma = leafwise.update(g, sa, pa)
        tree.update(clipped, sb, pb)
        assert torch.equal(ma["gnorm"], gn)
        for k in pa:
            assert pa[k].dtype == pb[k].dtype
            assert torch.equal(pa[k], pb[k]), (step, k)
        for x, y in zip(tree_leaves(sa), tree_leaves(sb)):
            assert torch.equal(x, y), step


def _compiled(fn, *args):
    """``fn`` compiled for ``args`` without XLA's costly backend passes
    (as ``tests/test_torch_train.py`` compiles the reference's step)."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})


def _batch(cfg, step, batch=4):
    return SyntheticTokenPipeline(cfg.vocab_size, batch, 16, seed=3
                                  ).batch_at(step)


def test_adafactor_steps_match_reference():
    """Three Adafactor steps of ``make_train_step`` on the reduced MoE
    (capacity factor 4.0, its aux loss in the loss), batch 4 x 16."""
    ref_cfg, cfg = configs()
    params = params_to_reference(port_tfm.init_model(
        cfg, torch.Generator().manual_seed(1), "cpu"), cfg)
    model = model_from_reference(cfg, params, "cpu")
    sched = (2, 10)
    ref_o = ref_opt.adafactor(ref_opt.cosine_schedule(LR, *sched))
    rp = jax.tree.map(jnp.asarray, params)
    rs = ref_o.init(rp)
    step = _compiled(ref_trainer.make_train_step(ref_cfg, None, ref_o, 1),
                     rp, rs, jax.tree.map(jnp.asarray, _batch(cfg, 0)))
    port_o = opt_mod.adafactor(opt_mod.cosine_schedule(LR, *sched),
                               stacks=trainer.stacked_leaves(model))
    ps = port_o.init(trainer.trainable_params(model))
    port_step = trainer.make_train_step(cfg, None, port_o, 1)
    for i in range(3):
        batch = _batch(cfg, i)
        rp, rs, rm = step(rp, rs, jax.tree.map(jnp.asarray, batch))
        model, ps, pm = port_step(model, ps, {
            k: torch.as_tensor(v) for k, v in batch.items()})
        assert float(pm["aux"]) > 0
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


@pytest.mark.parametrize("compress", [False, True])
def test_moe_training_with_adafactor_reduces_loss(compress):
    """``launch.train`` on the reduced MoE with Adafactor, with and
    without int8 gradient compression."""
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--optimizer",
            "adafactor", "--steps", "30", "--batch", "8", "--seq", "32",
            "--lr", "1e-2", "--ckpt", ""]
    losses = train_mod.main(argv + (["--compress-grads"] if compress
                                    else []))
    assert len(losses) == 30
    assert np.mean(losses[-3:]) < np.mean(losses[:3]) - 0.1, losses


def test_build_takes_either_optimizer():
    _, cfg = configs()
    model = port_tfm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    for name in ("adamw", "adafactor"):
        opt, _ = train_mod.build(cfg, model, optimizer=name)
        state = opt.init(trainer.trainable_params(model))
        assert ("m" in state) == (name == "adamw")
    with pytest.raises(ValueError):
        train_mod.build(cfg, model, optimizer="sgd")
