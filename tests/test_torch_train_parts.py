"""The parts of the port's training path against the reference on the
CPU: the optimizers (``repro_torch.train.optimizer``: AdamW and
Adafactor updates over three steps on the same parameters, gradients and
state; the cosine schedule), the chunked cross-entropy
(``repro_torch.train.losses``: loss, z^2 and gradients against
``_chunked_ce_dense`` and ``jax.grad`` of it, padded vocab included), the
synthetic pipeline, int8 gradient compression, ``elastic_assignment`` and
``TrainController`` (mirrors of ``tests/test_fault_tolerance.py``'s and
``tests/test_models_losses.py``'s cases, and the same inputs through
both packages), and checkpoints of bfloat16 state.

Inputs are numpy-seeded and fed to both packages. Tolerances: the
optimizers' parameters and states within 1e-6 (float32, the same
operations; ``b1 ** t`` and the cosine may differ in their last bit);
the schedule equal to the reference's float32 values at nine steps in
ten, and within base_lr x 2^-22 at the others: XLA's float32 cosine and
torch's differ in their last bit at some arguments (neither is
correctly rounded), which 1 + cos amplifies near the schedule's end; the
CE within rtol 1e-5 (loss) and atol 1e-6 (gradients,
whose entries are O(1/T)); compression and the pipeline bit for bit."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.data import SyntheticTokenPipeline as RefPipeline
from repro.distributed import collectives as ref_coll
from repro.distributed.fault_tolerance import \
    elastic_assignment as ref_elastic
from repro.models import transformer as ref_tfm
from repro.train import losses as ref_losses
from repro.train import optimizer as ref_opt
from repro_torch.checkpoint import ckpt
from repro_torch.data import SyntheticTokenPipeline
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.fault_tolerance import (TrainController,
                                                     elastic_assignment)
from repro_torch.train import losses, optimizer as opt_mod
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)
OPT_TOL = 1e-6


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.as_tensor(np.array(v)) for k, v in tree.items()}


def _assert_trees_close(port, ref, tol, path=""):
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref), path
        for k in ref:
            _assert_trees_close(port[k], ref[k], tol, f"{path}/{k}")
        return
    np.testing.assert_allclose(np.asarray(port.float()), np.asarray(ref),
                               rtol=tol, atol=tol, err_msg=path)


@functools.lru_cache(maxsize=None)
def _reference_params():
    """A reduced Qwen2's parameter tree, stacked groups included (the
    leaves Adafactor factors and clips as wholes)."""
    cfg = ref_reduced(ref_get_config("qwen2-1.5b"))
    return _np_tree(ref_tfm.init_model(jax.random.PRNGKey(0), cfg))


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 0.05)
                        .astype(np.float32), params)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_updates_match_reference(name):
    """Three steps from the same parameters on the same gradients: the
    parameters and every state leaf stay within OPT_TOL. A warm-up of 2
    and a total of 10, so the schedule's both halves run."""
    ref_o = getattr(ref_opt, name)(ref_opt.cosine_schedule(0.05, 2, 10))
    port_o = getattr(opt_mod, name)(opt_mod.cosine_schedule(0.05, 2, 10))
    params = _reference_params()
    rp = jax.tree.map(jnp.asarray, params)
    rs = ref_o.init(rp)
    update = jax.jit(ref_o.update)
    pp = _torch_tree(params)
    ps = port_o.init(pp)
    for step in range(3):
        g = _grads(params, step)
        rp, rs, rm = update(jax.tree.map(jnp.asarray, g), rs, rp)
        pp, ps, pm = port_o.update(_torch_tree(g), ps, pp)
        _assert_trees_close(pp, _np_tree(rp), OPT_TOL)
        ref_state = _np_tree(rs)
        assert int(ps["step"]) == int(ref_state["step"])
        for key in ref_state:
            if key != "step":
                _assert_trees_close(ps[key], ref_state[key], OPT_TOL)
        assert float(pm["lr"]) == float(rm["lr"])
        np.testing.assert_allclose(float(pm["gnorm"]), float(rm["gnorm"]),
                                   rtol=1e-6)


@pytest.mark.parametrize("base_lr,warmup,total", [(3e-4, 20, 50),
                                                  (1e-3, 20, 30),
                                                  (0.1, 0, 100)])
def test_cosine_schedule_matches_reference_float32(base_lr, warmup, total):
    ref_lr = ref_opt.cosine_schedule(base_lr, warmup, total)
    port_lr = opt_mod.cosine_schedule(base_lr, warmup, total)
    steps = np.arange(0, total + 3, dtype=np.int32)
    want = np.array([np.float32(ref_lr(jnp.int32(s))) for s in steps])
    got = port_lr(torch.as_tensor(steps)).numpy()
    assert got.dtype == np.float32
    assert np.count_nonzero(got == want) >= 0.9 * len(steps)
    np.testing.assert_allclose(got, want, rtol=2 ** -22,
                               atol=base_lr * 2 ** -22)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_descends_quadratic(name):
    """Mirror of the reference's case."""
    opt = getattr(opt_mod, name)(opt_mod.cosine_schedule(0.1, 0, 100))
    params = {"w": torch.tensor([3.0, -2.0]), "m": torch.ones(4, 4)}

    def loss(p):
        return torch.sum(p["w"] ** 2) + torch.sum((p["m"] - 0.5) ** 2)

    state = opt.init(params)
    l0 = float(loss(params))
    for _ in range(60):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        g = dict(zip(leaves, torch.autograd.grad(loss(leaves),
                                                 list(leaves.values()))))
        params, state, _ = opt.update(g, state, params)
    assert float(loss(params)) < 0.1 * l0


def test_adafactor_state_is_factored():
    opt = opt_mod.adafactor(opt_mod.cosine_schedule(0.1, 0, 100))
    params = {"big": torch.ones(64, 32)}
    st_ = opt.init(params)
    leaf = st_["v"]["big"]
    assert leaf["vr"].shape == (64,) and leaf["vc"].shape == (32,)
    n_state = sum(x.numel() for x in (leaf["vr"], leaf["vc"], st_["step"]))
    assert n_state < params["big"].numel() // 10   # sublinear memory


# ---------------------------------------------------------------------------
# chunked cross-entropy
# ---------------------------------------------------------------------------


def _ce_inputs(B, S, D, Vp, V, seed=3):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    w = (rng.standard_normal((D, Vp)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    return h, w, labels


def test_chunked_ce_matches_dense_softmax():
    """Mirror of the reference's case: the padded vocab tail is masked."""
    B, S, D, V, Vp = 2, 8, 16, 50, 64
    h, w, labels = _ce_inputs(B, S, D, Vp, V)
    nll, _ = losses._chunked_ce_dense(torch.as_tensor(h), torch.as_tensor(w),
                                      torch.as_tensor(labels), 4, V)
    logits = (h.reshape(-1, D) @ w)[:, :V].astype(np.float64)
    lp = logits - logits.max(-1, keepdims=True)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    ref = -lp[np.arange(B * S), labels.reshape(-1)].mean()
    np.testing.assert_allclose(float(nll), ref, rtol=1e-5)


@pytest.mark.parametrize("B,S,n_chunks", [(2, 8, 4), (3, 5, 4), (1, 7, 1)])
def test_chunked_ce_and_grads_match_reference(B, S, n_chunks):
    """Loss, z^2 and the gradients of loss + 0.1 z^2 with respect to the
    hidden state and the unembedding, against ``_chunked_ce_dense`` and
    ``jax.grad`` of it; T = 15 does not divide into 4 chunks (padding)."""
    D, V, Vp = 16, 50, 64
    h, w, labels = _ce_inputs(B, S, D, Vp, V)

    def ref_loss(h_, w_):
        nll, zsq = ref_losses._chunked_ce_dense(h_, w_, jnp.asarray(labels),
                                                n_chunks, V)
        return nll + 0.1 * zsq, (nll, zsq)

    (_, (rn, rz)), (rgh, rgw) = jax.jit(jax.value_and_grad(
        ref_loss, argnums=(0, 1), has_aux=True))(jnp.asarray(h),
                                                 jnp.asarray(w))
    th = torch.as_tensor(h).requires_grad_(True)
    tw = torch.as_tensor(w).requires_grad_(True)
    nll, zsq = losses._chunked_ce_dense(th, tw, torch.as_tensor(labels),
                                        n_chunks, V)
    (nll + 0.1 * zsq).backward()
    np.testing.assert_allclose(nll.item(), float(rn), rtol=1e-5)
    np.testing.assert_allclose(zsq.item(), float(rz), rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(rgh), atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(rgw), atol=1e-6)
    assert not tw.grad[:, V:].any()          # the padded tail: no gradient


def test_vocab_parallel_ce_without_mesh_and_bf16_weights():
    """``vocab_parallel_ce`` with no mesh is the dense path on float32
    hidden; bf16 weights give a bf16 gradient, summed in float32; a mesh
    of one rank takes the same path bit for bit (the vocab-sharded path
    is held in ``tests/test_torch_mesh_train.py``)."""
    from repro_torch.configs import get_config, reduced
    cfg = reduced(get_config("qwen2-1.5b"))
    h, w, labels = _ce_inputs(2, 6, 16, 64, 50)
    th = torch.as_tensor(h).bfloat16().requires_grad_(True)
    tw = torch.as_tensor(w).bfloat16().requires_grad_(True)
    tl = torch.as_tensor(labels)
    loss = losses.vocab_parallel_ce(th, tw, tl, cfg, None, n_chunks=3)
    want = losses._chunked_ce_dense(th.float(), tw, tl, 3,
                                    cfg.vocab_size)[0]
    assert torch.equal(loss, want)
    loss.backward()
    assert th.grad.dtype == tw.grad.dtype == torch.bfloat16
    from repro_torch.distributed.sharding import local_ctx
    assert torch.equal(losses.vocab_parallel_ce(th, tw, tl, cfg,
                                                local_ctx(cfg), n_chunks=3),
                       want)


# ---------------------------------------------------------------------------
# pipeline, compression, elasticity, controller, checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("structured", [True, False])
def test_pipeline_batches_equal_reference(structured):
    for shard in (0, 1):
        ref = RefPipeline(1000, 8, 16, seed=5, shard=shard, n_shards=2,
                          structured=structured)
        port = SyntheticTokenPipeline(1000, 8, 16, seed=5, shard=shard,
                                      n_shards=2, structured=structured)
        for step in (0, 3, 77):
            a, b = port.batch_at(step)["tokens"], ref.batch_at(step)["tokens"]
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_data_pipeline_determinism_and_prefetch():
    """Mirror of the reference's case."""
    p1 = SyntheticTokenPipeline(1000, 8, 16, seed=5, shard=0, n_shards=2)
    p2 = SyntheticTokenPipeline(1000, 8, 16, seed=5, shard=0, n_shards=2)
    np.testing.assert_array_equal(p1.batch_at(3)["tokens"],
                                  p2.batch_at(3)["tokens"])
    it = p1.iterator(start_step=0)
    b0 = next(it)
    np.testing.assert_array_equal(b0["tokens"], p1.batch_at(0)["tokens"])
    np.testing.assert_array_equal(next(it)["tokens"],
                                  p1.batch_at(1)["tokens"])
    p1.stop()
    p3 = SyntheticTokenPipeline(1000, 8, 16, seed=5, shard=1, n_shards=2)
    assert not np.array_equal(p3.batch_at(3)["tokens"],
                              p2.batch_at(3)["tokens"])


def _grad_seq(n=20):
    rng = np.random.default_rng(0)
    return [{"w": (rng.normal(size=(32, 32))
                   * (10.0 ** rng.integers(-3, 2))).astype(np.float32),
             "b": {"c": rng.normal(size=(7,)).astype(np.float32)}}
            for _ in range(n)]


def test_gradient_compression_error_feedback():
    """Mirror of the reference's case: the running sum of compressed
    gradients tracks the true sum within the carried error."""
    seq = _grad_seq()
    err = coll.init_error_state(_torch_tree(seq[0]))
    true_sum = torch.zeros(32, 32)
    comp_sum = torch.zeros(32, 32)
    for g in seq:
        cg, err = coll.compress_gradients(_torch_tree(g), err)
        true_sum = true_sum + torch.as_tensor(g["w"])
        comp_sum = comp_sum + cg["w"]
    resid = (true_sum - comp_sum).abs()
    assert float(resid.max()) <= float(err["w"].abs().max()) + 1e-5


def test_compress_gradients_matches_reference():
    """Dequantized gradients and the carried error, bit for bit, over 20
    steps; quantize_int8's int8 payload and scale too."""
    seq = _grad_seq()
    r_err = ref_coll.init_error_state(jax.tree.map(jnp.asarray, seq[0]))
    p_err = coll.init_error_state(_torch_tree(seq[0]))
    for g in seq:
        r_g, r_err = ref_coll.compress_gradients(
            jax.tree.map(jnp.asarray, g), r_err)
        p_g, p_err = coll.compress_gradients(_torch_tree(g), p_err)
        for a, b in ((p_g, r_g), (p_err, r_err)):
            for x, y in zip(tree_leaves(a), jax.tree.leaves(b)):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    q, s, e = coll.quantize_int8(torch.as_tensor(seq[0]["w"]),
                                 torch.zeros(32, 32))
    rq, rs, re_ = ref_coll.quantize_int8(jnp.asarray(seq[0]["w"]),
                                         jnp.zeros((32, 32)))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)
    np.testing.assert_array_equal(e.numpy(), np.asarray(re_))


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 1000), st.integers(1, 16), st.integers(1, 64))
def test_elastic_assignment_matches_reference(step, n_alive, batch_mult):
    alive = list(range(n_alive))
    gb = n_alive * batch_mult + step % n_alive
    asg = elastic_assignment(step, alive, gb)
    assert asg == ref_elastic(step, alive, gb)
    sizes = [asg[h][1] for h in alive]
    assert sum(sizes) == gb and max(sizes) - min(sizes) <= 1


def test_elastic_assignment_rebalances_on_death():
    a1 = elastic_assignment(11, [0, 1, 3], 64)    # host 2 died
    assert a1 == ref_elastic(11, [0, 1, 3], 64)
    assert sum(s for _, s in a1.values()) == 64 and 2 not in a1


def test_train_controller_resume_after_failure(tmp_path, monkeypatch):
    """Mirror of the reference's case with the port's CheckpointManager:
    crash at step 5, the crash path saves step 5, the resumed run ends
    where an uninterrupted one does, exactly."""
    monkeypatch.delenv("_resumed", raising=False)

    def step_fn(state, batch):
        return state + batch["x"], {"s": state}

    def batch_fn(step):
        return {"x": torch.tensor(step + 1, dtype=torch.float32)}

    class Boom(RuntimeError):
        pass

    def injector(step):
        if step == 5:
            raise Boom()

    mgr = ckpt.CheckpointManager(str(tmp_path), save_interval=2, keep=3,
                                 async_save=False)
    ctl = TrainController(step_fn, batch_fn, mgr, max_steps=9,
                          failure_injector=injector)
    with pytest.raises(Boom):
        ctl.run(torch.tensor(0.0), install_sigterm=False)
    s = ckpt.latest_step(str(tmp_path))
    assert s == 5                     # forced save on the crash path
    state = ckpt.restore(str(tmp_path), s, torch.tensor(0.0), "cpu")
    ctl2 = TrainController(step_fn, batch_fn, mgr, max_steps=9)
    final, step, _ = ctl2.run(state, start_step=s, install_sigterm=False)
    assert step == 9
    assert float(final) == sum(range(1, 10))


def test_checkpoint_keeps_bfloat16_state_bit_for_bit(tmp_path):
    rng = np.random.default_rng(1)
    tree = ({"w": torch.as_tensor(rng.standard_normal((5, 3))).bfloat16(),
             "s": torch.tensor(1.5, dtype=torch.bfloat16)},
            {"m": torch.as_tensor(rng.standard_normal(4)).float(),
             "step": torch.tensor(3, dtype=torch.int32)}, ())
    ckpt.save(str(tmp_path), 4, tree)
    back = ckpt.restore(str(tmp_path), 4, tree, "cpu")
    for part, got in zip(tree[:2], back[:2]):
        for k in part:
            assert got[k].dtype == part[k].dtype
            assert got[k].shape == part[k].shape
            assert torch.equal(got[k], part[k])
    assert back[2] == ()
