"""Training under a ``("data", "model")`` mesh on the CPU, held against the
reference's mesh step.

The reference runs once for the file, in REFERENCE_PARTS children side
by side, each with four forced host devices (``--reference``): under ``jax.sharding.Mesh`` meshes (built as
``repro/launch/train.py`` builds its mesh: ``jax.make_mesh`` gives
Explicit axes, on which the reference's sharding constraints raise) it
computes its vocab-parallel cross-entropy at (1, 2) and (2, 2) (loss, dh,
dW), ``compressed_psum`` over ``data`` 2 inside ``shard_map``, the
``make_batch_spec`` specs, and one training step of each case in
``STEP_CASES``: its ``make_train_step`` body, ``value_and_grad`` of
``loss_fn`` under the mesh, then each optimizer's ``update`` of those
gradients (one update program an architecture serves every mesh).

The port runs in four gloo ranks on 127.0.0.1 (``--rank``), a process
each, over a 2 x 2 device mesh: the (2, 2) cases on all four, the (1, 2)
cases on its two ``model`` rows at once and the (2, 1) ones on its
``data`` columns (``SubMesh``). Each rank draws the whole leaves from the
same seed and keeps its shards; the gradients, parameters and optimizer
state are gathered whole for the comparison. The ranks also hold the
collectives that pass through their shared host buffer to gloo's own,
bit for bit. Ranks 0 and 1 then join a group of
their own and run ``launch.train --production-mesh`` with
``REPRO_TEST_MESH=1x2``.

Bars: the loss, aux and gnorm within 1e-5 relative (float32 sums over
ranks in another order); every gradient leaf within 1e-5 of its norm and
every optimizer moment within twice that (for RWKV6, whose float32
gradients move by as much with the order of the scan's sums, what the
mesh changes against a step with no mesh, on each side; its ``mix.u``
within ``LOOSE_FACTOR`` times those); the parameters after one step (lr 1e-3) within
``PARAM_ATOL``, the reference's own mesh-against-``ctx=None`` gap at that
lr (4.2e-5, set by AdamW's first step, which moves each element by about
lr whatever its gradient's size). The MoE at (2, 2) is held to the
reference's per-data-shard routing (its capacity and aux loss come from
each shard's tokens, the aux reported is shard 0's), the MoE at (2, 1) to
its global routing. The elastic restore is bit for bit.
"""
import dataclasses
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.distributed import sharding as sh
from repro_torch.interop import params_to_reference
from repro_torch.models import transformer as tfm
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import trainer

ROOT = Path(__file__).resolve().parents[1]
B, S, SEED, LR = 4, 16, 1, 1e-3
SCHED = (2, 10)                 # warm-up, total steps of the cosine
TOL = 1e-5                      # relative: loss, gnorm, leaves by norm
PARAM_ATOL = 4.2e-5             # the reference's own mesh-vs-None gap
# RWKV6's float32 gradients move by up to 1.4e-5 of a leaf's norm with the
# order of the WKV scan's sums (the port's ctx=None gradients against the
# reference's, before any mesh), as much as the bar: for the
# NO_MESH_CASES each side's step is also taken with no mesh, and what the
# mesh changes (the mesh step less the no-mesh step) is held to what it
# changes in the reference, each leaf within the bar of its norm; its
# ``mix.u`` (the WKV bonus, whose gradient sums the scan's terms with
# cancellation: the mesh moves it by 1.9e-5 of its norm) at LOOSE_FACTOR
# times the bar
NO_MESH_CASES = ("rwkv6 1x2",)
LOOSE_LEAVES = ("/mix/u",)
LOOSE_FACTOR = 4.0
SPAWN_TIMEOUT = 300
TENSOR, EXPERT = dict(moe_sharding="tensor"), dict(moe_sharding="expert")
# name: (arch, mesh shape, fsdp, optimizers, config fields replaced)
STEP_CASES = {
    "qwen2 1x2": ("qwen2-1.5b", (1, 2), False, ("adamw", "adafactor"), {}),
    "qwen2 2x2": ("qwen2-1.5b", (2, 2), False, ("adamw", "adafactor"), {}),
    "qwen2 2x2 fsdp": ("qwen2-1.5b", (2, 2), True, ("adamw", "adafactor"),
                       {}),
    "moe tensor 1x2": ("qwen2-moe-a2.7b", (1, 2), False, ("adafactor",),
                       TENSOR),
    "moe expert 1x2": ("qwen2-moe-a2.7b", (1, 2), False, ("adamw",),
                       EXPERT),
    "moe tensor 2x2": ("qwen2-moe-a2.7b", (2, 2), False, ("adamw",),
                       TENSOR),
    # capacity factor 0.5: assignments drop, by each data shard's count
    # at (2, 2) and by the global batch's at (2, 1)
    "moe tensor 2x2 drops": ("qwen2-moe-a2.7b", (2, 2), False, ("adamw",),
                             dict(TENSOR, capacity_factor=0.5)),
    "moe tensor 2x1 drops": ("qwen2-moe-a2.7b", (2, 1), False, ("adamw",),
                             dict(TENSOR, capacity_factor=0.5)),
    "recurrentgemma 1x2": ("recurrentgemma-2b", (1, 2), False, ("adamw",),
                           {}),
    "rwkv6 1x2": ("rwkv6-3b", (1, 2), False, ("adamw",), {}),
}
CE_SHAPES = ((1, 2), (2, 2))
CE_VOCAB = 500                  # padded to 512: the tail is masked
SPEC_CASES = {"qwen2 2x2": ("qwen2-1.5b", (2, 2), ("data", "model")),
              "musicgen 1x4": ("musicgen-large", (1, 4), ("data", "model")),
              "qwen2 pod": ("qwen2-1.5b", (2, 2, 1),
                            ("pod", "data", "model"))}
TRAIN_ARGS = ["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
              "--steps", "3", "--batch", "4", "--seq", "16", "--lr", "3e-3"]


def _cfg(arch, rep=None, reference=False):
    if reference:
        from repro.configs import get_config as g, reduced as r
    else:
        g, r = get_config, reduced
    return dataclasses.replace(r(g(arch)), **(rep or {}))


def _tokens(cfg, step=0):
    from repro_torch.data import SyntheticTokenPipeline
    return SyntheticTokenPipeline(cfg.vocab_size, B, S, seed=3
                                  ).batch_at(step)["tokens"]


def _ce_inputs():
    rng = np.random.default_rng(5)
    h = rng.standard_normal((B, S, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 512)) * 0.1).astype(np.float32)
    lab = rng.integers(0, CE_VOCAB, (B, S)).astype(np.int32)
    return h, w, lab


def _psum_inputs():
    rng = np.random.default_rng(6)
    return (rng.standard_normal((2, 3, 40)).astype(np.float32),
            (rng.standard_normal((2, 3, 40)) * 1e-3).astype(np.float32))


# ---------------------------------------------------------------------------
# the reference, in a child with four host devices
# ---------------------------------------------------------------------------


# the reference's children: each computes every REFERENCE_PARTS-th step
# case, the first also the CE, compressed_psum and the batch specs
REFERENCE_PARTS = 2


def reference(out, part=0):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.distributed.sharding import make_ctx
    from repro.train import optimizer as ropt
    from repro.train import trainer as rtrainer

    opts = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}

    def compiled(fn, *args):
        return jax.jit(fn).lower(*args).compile(compiler_options=opts)

    def mesh(shape, axes=("data", "model")):
        n = int(np.prod(shape))
        return Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)

    host = jax.tree.map
    res = {"ce": {}, "steps": {}, "specs": {}}
    if part == 0:
        _reference_parts(res, compiled, mesh)
    updates = {}
    for i, (name, (arch, shape, fsdp, optims, rep)) in enumerate(
            STEP_CASES.items()):
        if i % REFERENCE_PARTS != part:
            continue
        cfg = _cfg(arch, rep, reference=True)
        pcfg = _cfg(arch, rep)
        params = host(jnp.asarray, params_to_reference(tfm.init_model(
            pcfg, torch.Generator().manual_seed(SEED), "cpu"), pcfg))
        batch = dict(tokens=jnp.asarray(_tokens(pcfg)))
        m = mesh(shape)
        ctx = make_ctx(cfg, m, fsdp=fsdp)
        grad = jax.value_and_grad(lambda p, b: rtrainer.loss_fn(
            p, b, cfg, ctx), has_aux=True)
        with m:
            (loss, parts), grads = compiled(grad, params, batch)(params,
                                                                  batch)
        row = dict(loss=float(loss), aux=float(parts["aux"]),
                   grads=host(np.asarray, grads))
        if name in NO_MESH_CASES:
            _, none = compiled(jax.value_and_grad(
                lambda p, b: rtrainer.loss_fn(p, b, cfg, None),
                has_aux=True), params, batch)(params, batch)
            row["grads_none"] = host(np.asarray, none)
        # the update on one device: GSPMD's over the global arrays
        grads = host(jnp.asarray, row["grads"])
        for on in optims:
            o = getattr(ropt, on)(ropt.cosine_schedule(LR, *SCHED))
            state = o.init(params)
            key = (arch, on)
            if key not in updates:
                updates[key] = compiled(o.update, grads, state, params)
            new_p, new_s, met = updates[key](grads, state, params)
            row[on] = dict(params=host(np.asarray, new_p),
                           state=host(np.asarray, new_s),
                           gnorm=float(met["gnorm"]))
            if name in NO_MESH_CASES:
                row[on]["state_none"] = host(np.asarray, updates[key](
                    host(jnp.asarray, row["grads_none"]), state,
                    params)[1])
        res["steps"][name] = row
    torch.save(res, out)


def _reference_parts(res, compiled, mesh):
    """The reference's CE at CE_SHAPES, ``compressed_psum`` over ``data``
    2 in ``shard_map`` and the batch specs, into ``res``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as PS
    from repro.compat import shard_map
    from repro.distributed import collectives as rcoll
    from repro.distributed.sharding import make_ctx
    from repro.train import losses as rlosses
    from repro.train import trainer as rtrainer

    h, w, lab = _ce_inputs()
    cfg = dataclasses.replace(_cfg("qwen2-1.5b", reference=True),
                              vocab_size=CE_VOCAB)
    for shape in CE_SHAPES:
        m = mesh(shape)
        ctx = make_ctx(cfg, m)
        fn = jax.value_and_grad(lambda h_, w_: rlosses.vocab_parallel_ce(
            h_, w_, jnp.asarray(lab), cfg, ctx), argnums=(0, 1))
        with m:
            loss, (dh, dw) = compiled(fn, h, w)(h, w)
        res["ce"][shape] = dict(loss=float(loss), dh=np.asarray(dh),
                                dw=np.asarray(dw))
    x, err = _psum_inputs()
    m = mesh((2, 1))

    def body(x_, e_):
        q, scale, _ = rcoll.quantize_int8(x_, e_)
        y, ne = rcoll.compressed_psum(x_, "data", e_)
        return q, scale[None], y, ne

    with m:
        q, scale, y, ne = jax.jit(shard_map(
            body, mesh=m, in_specs=(PS("data"), PS("data")),
            out_specs=(PS("data"), PS("data"), PS("data"), PS("data")),
            check_vma=False))(x, err)
    res["psum"] = dict(q=np.asarray(q), scale=np.asarray(scale),
                       y=np.asarray(y), err=np.asarray(ne))
    for name, (arch, shape, axes) in SPEC_CASES.items():
        ctx = make_ctx(_cfg(arch, reference=True), mesh(shape, axes))
        specs, shardings = rtrainer.make_batch_spec(
            _cfg(arch, reference=True), ctx, 8, 32)
        res["specs"][name] = {k: (tuple(v.shape), str(v.dtype),
                                  tuple(shardings[k].spec))
                              for k, v in specs.items()}


# ---------------------------------------------------------------------------
# a rank
# ---------------------------------------------------------------------------


class SubMesh:
    """A ``("data", "model")`` mesh over one row (``keep="model"``: (1,
    2)) or one column (``keep="data"``: (2, 1)) of a 2 x 2 ``DeviceMesh``:
    its shape, this rank's coordinate and the full mesh's process group
    of the kept axis, as ``ShardCtx`` reads them."""
    mesh_dim_names = ("data", "model")

    def __init__(self, full, keep):
        data, model = full.get_coordinate()
        self.full, self.keep = full, keep
        self.shape = (1, 2) if keep == "model" else (2, 1)
        self.coordinate = [0, model] if keep == "model" else [data, 0]

    def get_coordinate(self):
        return self.coordinate

    def get_group(self, axis):
        return self.full.get_group(axis)


def _whole(ctx, params, tree):
    """Each tensor of ``tree`` (by parameter name) gathered whole."""
    return {k: sh.NamedSharding(ctx, params[k].axes).gather(v.detach())
            for k, v in tree.items()}


def _whole_state(ctx, params, state):
    shard = trainer.state_shardings(state, params, ctx)

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(t[k], s[k]) for k in t}
        return t.clone() if s is None else s.gather(t)
    return walk(state, shard)


def _step_case(name, ctx):
    arch, shape, fsdp, optims, rep = STEP_CASES[name]
    cfg = _cfg(arch, rep)
    batch = trainer.local_batch(dict(tokens=torch.as_tensor(
        _tokens(cfg))), ctx)
    model = tfm.init_model(cfg, torch.Generator().manual_seed(SEED), "cpu",
                           ctx=ctx)
    params = trainer.trainable_params(model)
    out = {}
    for on in optims:
        if on != optims[0]:
            model = tfm.init_model(cfg, torch.Generator().manual_seed(SEED),
                                   "cpu", ctx=ctx)
            params = trainer.trainable_params(model)
        kw = {} if on == "adamw" else dict(
            stacks=trainer.stacked_leaves(model))
        o = getattr(opt_mod, on)(opt_mod.cosine_schedule(LR, *SCHED), **kw)
        state = o.init(params)
        (loss, parts), grads = trainer.value_and_grad(model, batch, cfg, ctx)
        grads = trainer.reduce_gradients(grads, params, ctx)
        _, state, met = o.update(grads, state, params, ctx=ctx)
        out[on] = dict(loss=float(loss), aux=float(parts["aux"]),
                       gnorm=float(met["gnorm"]),
                       grads=_whole(ctx, params, grads),
                       params=_whole(ctx, params, params),
                       state=_whole_state(ctx, params, state))
        if name in NO_MESH_CASES:
            model = tfm.init_model(cfg, torch.Generator().manual_seed(SEED),
                                   "cpu")
            params = trainer.trainable_params(model)
            _, grads = trainer.value_and_grad(model, dict(
                tokens=torch.as_tensor(_tokens(cfg))), cfg)
            out[on]["grads_none"] = grads
            out[on]["state_none"] = o.update(grads, o.init(params),
                                             params)[1]
    return out


def _ce_case(shape, ctx):
    from repro_torch.distributed.collectives import mesh_collective
    from repro_torch.train.losses import vocab_parallel_ce

    h, w, lab = (torch.as_tensor(a) for a in _ce_inputs())
    cfg = dataclasses.replace(_cfg("qwen2-1.5b"), vocab_size=CE_VOCAB)
    hl = ctx.local(h, ("batch", None, None)).clone().requires_grad_(True)
    wl = ctx.local(w, (None, "vocab")).clone().requires_grad_(True)
    loss = vocab_parallel_ce(hl, wl, ctx.local(lab, ("batch", None)), cfg,
                             ctx)
    dh, dw = torch.autograd.grad(loss, (hl, wl))
    dw = mesh_collective("sum", dw, ctx, "data")
    return dict(loss=float(loss),
                dh=sh.NamedSharding(ctx, ("batch", None, None)).gather(dh),
                dw=sh.NamedSharding(ctx, (None, "vocab")).gather(dw))


def _psum_case(ctx):
    from repro_torch.distributed.collectives import (compressed_psum,
                                                     quantize_int8)

    x, err = (torch.as_tensor(a)[ctx.index("data")] for a in _psum_inputs())
    q, scale, _ = quantize_int8(x, err)
    y, ne = compressed_psum(x, "data", err, ctx)
    return dict(q=q, scale=scale, y=y, err=ne)


def _exchange_case(full):
    """Each collective kind (through the ranks' shared host buffer)
    against gloo's own collectives, over each axis of the 2 x 2 mesh,
    float32 and bfloat16, a small tensor and one of a megabyte (which
    grows the buffer): equal bit for bit."""
    import torch.distributed as dist
    from repro_torch.distributed import collectives as coll

    ok = {}
    for axis in ("data", "model"):
        group = full.get_group(axis)
        for dt in (torch.float32, torch.bfloat16):
            for shape in ((2, 4, 3), (4, 256, 300)):
                x = torch.randn(*shape, generator=torch.Generator(
                ).manual_seed(dist.get_rank())).to(dt)
                parts = [torch.empty_like(x.float()) for _ in range(2)]
                dist.all_gather(parts, x.float(), group=group)
                total = parts[0] + parts[1]
                c, r = shape[1] // 2, dist.get_rank(group)
                for kind, want in (
                        ("sum", total.to(dt)), ("mean", (total / 2).to(dt)),
                        ("max", torch.maximum(*parts).to(dt)),
                        ("gather", torch.cat(parts, 1).to(dt)),
                        ("reduce_scatter",
                         total.to(dt)[:, c * r:c * (r + 1)])):
                    got = coll.mesh_collective(kind, x, group=group, dim=1)
                    ok[f"{axis} {dt} {shape} {kind}"] = bool(
                        torch.equal(got, want))
        ok[f"{axis} shared"] = isinstance(coll._SHARED.get(group),
                                          coll._Slots)
    return ok


def _elastic(full, d):
    """Save after one (1, 2) step; restore onto (2, 1) with FSDP; one
    more step on each."""
    from repro_torch.checkpoint import ckpt

    cfg = _cfg("qwen2-1.5b")
    row, col = SubMesh(full, "model"), SubMesh(full, "data")
    out = {}

    def build(ctx):
        model = tfm.init_model(cfg, torch.Generator().manual_seed(SEED),
                               "cpu", ctx=ctx)
        params = trainer.trainable_params(model)
        o = opt_mod.adamw(opt_mod.cosine_schedule(LR, *SCHED))
        return model, params, o, o.init(params)

    def step(model, o, state, ctx, i):
        batch = trainer.local_batch(dict(tokens=torch.as_tensor(
            _tokens(cfg, i))), ctx)
        _, state, met = trainer.make_train_step(cfg, ctx, o)(model, state,
                                                               batch)
        return float(met["loss"])

    ctx12 = sh.make_ctx(cfg, row)
    if full.get_coordinate()[0] == 0:         # the first row trains, saves
        model, params, o, st = build(ctx12)
        step(model, o, st, ctx12, 0)
        tree = (params, st, ())
        shard = trainer.state_shardings(tree, params, ctx12)
        mgr = ckpt.CheckpointManager(d, save_interval=1, async_save=True,
                                     shardings=shard)
        mgr.maybe_save(1, tree)
        mgr.wait()
        out["saved"] = ckpt._map_leaves(lambda _, t: t.clone(),
                                        ckpt.gather_tree(tree, shard))
        out["loss2_12"] = step(model, o, st, ctx12, 1)
    torch.distributed.barrier()
    ctx21 = sh.make_ctx(cfg, col, fsdp=True)
    model, params, o, st = build(ctx21)
    tree = (params, st, ())
    shard = trainer.state_shardings(tree, params, ctx21)
    found, back = ckpt.CheckpointManager(d).restore_latest(tree, "cpu",
                                                           shard)
    from repro_torch.launch.train import copy_state
    copy_state(tree, back)
    out["restored_step"] = found
    out["restored"] = ckpt._map_leaves(lambda _, t: t.clone(),
                                       ckpt.gather_tree(tree, shard))
    out["shard_shapes"] = {k: tuple(v.shape) for k, v in params.items()}
    out["loss2_21"] = step(model, o, st, ctx21, 1)
    return out


def _rank(rank, world, port, port2, d, out):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.collectives import counts, reset_counts

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    full = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    meshes = {(2, 2): full, (1, 2): SubMesh(full, "model"),
              (2, 1): SubMesh(full, "data")}
    data, model = full.get_coordinate()
    report = {"steps": {}, "ce": {}}
    reset_counts()
    # the (1, 2) cases split between the two rows, the (2, 1) ones between
    # the columns; every rank takes every (2, 2) case
    for i, name in enumerate(STEP_CASES):
        shape = STEP_CASES[name][1]
        if (shape == (1, 2) and i % 2 != data) or (
                shape == (2, 1) and i % 2 != model):
            continue
        ctx = sh.make_ctx(_cfg(*STEP_CASES[name][::4]), meshes[shape],
                          fsdp=STEP_CASES[name][2])
        got = _step_case(name, ctx)
        if ctx.index("data") == 0 and ctx.index("model") == 0:
            report["steps"][name] = got
    for shape in CE_SHAPES:
        ctx = sh.make_ctx(_cfg("qwen2-1.5b"), meshes[shape])
        got = _ce_case(shape, ctx)
        if rank == 0:
            report["ce"][shape] = got
    psum = _psum_case(sh.make_ctx(_cfg("qwen2-1.5b"), meshes[(2, 1)]))
    if model == 0:
        report[f"psum{data}"] = psum
    report["exchange"] = _exchange_case(full)
    report["elastic"] = _elastic(full, d)
    report["collectives"] = counts()
    dist.destroy_process_group()
    if rank < 2:
        from repro_torch.launch import train as train_mod
        dist.init_process_group("gloo",
                                init_method=f"tcp://127.0.0.1:{port2}",
                                rank=rank, world_size=2)
        os.environ["REPRO_TEST_MESH"] = "1x2"
        report["launch"] = {
            c: train_mod.main(TRAIN_ARGS + ["--production-mesh", "--ckpt",
                                            os.path.join(d, f"l{c}"),
                                            "--ckpt-every", "2"]
                              + (["--compress-grads"] if c else []))
            for c in (0, 1)}
        dist.destroy_process_group()
    torch.save(report, out)


# ---------------------------------------------------------------------------
# the runs
# ---------------------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1", **extra)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, the four ranks' reports, the checkpoint dir),
    the reference's child and the ranks run side by side."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    ref_outs = [tmp / f"reference{j}.pt" for j in range(REFERENCE_PARTS)]
    port, port2 = _free_port(), _free_port()
    outs = [tmp / f"rank{r}.pt" for r in range(4)]
    ckdir = tmp / "ckpt"
    ckdir.mkdir()
    cmds = [[sys.executable, __file__, "--reference", str(o), str(j)]
            for j, o in enumerate(ref_outs)]
    cmds += [[sys.executable, __file__, "--rank", str(r), "4", str(port),
              str(port2), str(ckdir), str(outs[r])] for r in range(4)]
    # the reference's children alone see four host devices
    env = _env()
    procs_env = [dict(env, XLA_FLAGS="--xla_force_host_platform_device_"
                      "count=4", JAX_PLATFORMS="cpu")] * REFERENCE_PARTS + [
                          env] * 4
    procs = [subprocess.Popen(c, env=e, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for c, e in zip(cmds, procs_env)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = [torch.load(o, weights_only=False) for o in outs]
    ref = torch.load(ref_outs[0], weights_only=False)
    for o in ref_outs[1:]:
        ref["steps"].update(torch.load(o, weights_only=False)["steps"])
    return ref, ranks, ckdir


def _rank_with(ranks, key, name):
    got = [r[key][name] for r in ranks if name in r[key]]
    assert len(got) == 1, (key, name, len(got))
    return got[0]


def _close(got, want, what, tol=TOL, got0=0.0, want0=0.0):
    """``got`` within ``tol`` of ``want``'s norm; with the no-mesh steps
    ``got0`` and ``want0``, ``got - got0`` within it of ``want - want0``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.linalg.norm((got - np.asarray(got0, np.float64))
                         - (want - np.asarray(want0, np.float64)))
    assert err <= tol * max(np.linalg.norm(want), 1e-30), (
        what, err, np.linalg.norm(want))


def _tree_close(got, want, path="", tol=TOL, got0=None, want0=None):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _tree_close(got[k], want[k], f"{path}/{k}", tol,
                        None if got0 is None else got0[k],
                        None if want0 is None else want0[k])
        return
    if got0 is not None:
        tol *= LOOSE_FACTOR if path.endswith(LOOSE_LEAVES) else 1.0
        _close(got, want, path, tol, got0, want0)
    else:
        _close(got, want, path, tol)


def _full_model(arch, rep):
    cfg = _cfg(arch, rep)
    return cfg, tfm.Transformer(cfg, "cpu")


def _ref_layout(arch, rep, tensors):
    cfg, model = _full_model(arch, rep)
    return params_to_reference(model, cfg, tensors)


def _adafactor_layout(arch, rep, v):
    """The port's per-layer Adafactor state in the reference's stacked
    layout: each leaf's ``vr`` and ``vc`` (or ``v``) stacked with its
    layers, a stack of vectors' shared ``vc`` (a copy in each slice)
    once."""
    from repro_torch.interop import param_map

    cfg, model = _full_model(arch, rep)
    parts = {k: params_to_reference(model, cfg, {
        n: s.get(k, torch.zeros(())) for n, s in v.items()})
        for k in ("v", "vr", "vc")}
    out = {}
    for path, r, name in param_map(cfg):
        if r:
            continue
        leaf = {}
        for k in v[name]:
            a = parts[k]
            for key in path:
                a = a[key]
            if k == "vc" and v[name]["vr"].dim() == 0 and r is not None:
                a = a[0]
            leaf[k] = a
        d = out
        for key in path[:-1]:
            d = d.setdefault(key, {})
        d[path[-1]] = leaf
    return out


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_train_step_matches_reference_mesh_step(runs, name):
    ref, ranks, _ = runs
    arch, _, _, optims, rep = STEP_CASES[name]
    want = ref["steps"][name]
    got = _rank_with(ranks, "steps", name)
    for on in optims:
        g = got[on]
        np.testing.assert_allclose(g["loss"], want["loss"], rtol=TOL)
        np.testing.assert_allclose(g["aux"], want["aux"], rtol=TOL,
                                   atol=1e-7)
        np.testing.assert_allclose(g["gnorm"], want[on]["gnorm"], rtol=TOL)
        none = name in NO_MESH_CASES
        _tree_close(_ref_layout(arch, rep, g["grads"]), want["grads"],
                    got0=_ref_layout(arch, rep, g["grads_none"])
                    if none else None,
                    want0=want.get("grads_none"))
        p = _ref_layout(arch, rep, g["params"])
        for a, b in zip(_leaves(p), _leaves(want[on]["params"])):
            assert np.abs(np.asarray(a) - np.asarray(b)).max() <= PARAM_ATOL
        st = g["state"]
        if on == "adamw":
            for k in ("m", "v"):
                _tree_close(_ref_layout(arch, rep, st[k]),
                            want[on]["state"][k], k, 2 * TOL,
                            got0=_ref_layout(arch, rep, g["state_none"][k])
                            if none else None,
                            want0=want[on]["state_none"][k] if none
                            else None)
        else:
            _tree_close(_adafactor_layout(arch, rep, st["v"]),
                        want[on]["state"]["v"], "v", 2 * TOL)
        assert int(st["step"]) == int(want[on]["state"]["step"]) == 1


def _leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    return [t]


@pytest.mark.parametrize("shape", CE_SHAPES, ids=lambda s: "x".join(
    map(str, s)))
def test_vocab_parallel_ce_matches_reference(runs, shape):
    ref, ranks, _ = runs
    got, want = ranks[0]["ce"][shape], ref["ce"][shape]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["dh"], want["dh"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["dw"], want["dw"], rtol=0, atol=1e-5)


def test_compressed_psum_matches_reference(runs):
    ref, ranks, _ = runs
    want = ref["psum"]
    for d in (0, 1):
        got = next(r[f"psum{d}"] for r in ranks if f"psum{d}" in r)
        assert np.array_equal(got["q"].numpy(), want["q"][d])
        assert float(got["scale"]) == float(want["scale"][d])
        np.testing.assert_allclose(got["y"], want["y"][d], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(got["err"], want["err"][d], rtol=0,
                                   atol=1e-6)


def test_shared_buffer_collectives_equal_gloo_s(runs):
    """Ranks on one host pass their collectives through a host buffer they
    all map: sums, maxima, means, gathers and reduce-scatters equal gloo's
    own."""
    for r in runs[1]:
        assert all(r["exchange"].values()), r["exchange"]


def test_elastic_restore_is_bit_for_bit(runs):
    """Saved on (1, 2), restored onto (2, 1) with FSDP (each rank its
    ``data`` shards) and onto one process: every leaf equal bit for bit,
    and the next step's loss the unbroken run's."""
    from repro_torch.checkpoint import ckpt

    _, ranks, d = runs
    saved = ranks[0]["elastic"]["saved"]
    step = ckpt.latest_step(str(d))
    assert step == 1
    one = ckpt.restore(str(d), step, saved, "cpu")
    for r in ranks:
        e = r["elastic"]
        assert e["restored_step"] == 1
        for got, want in ((e["restored"], saved), (one, saved)):
            for a, b in zip(_flat(got), _flat(want)):
                assert a.dtype == b.dtype and torch.equal(a, b)
        # FSDP cut each embed dim over data
        assert e["shard_shapes"]["embed"][1] == 32
        np.testing.assert_allclose(e["loss2_21"],
                                   ranks[0]["elastic"]["loss2_12"],
                                   rtol=TOL)


def _flat(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _flat(t[k])]
    if isinstance(t, (list, tuple)):
        return [x for v in t for x in _flat(v)]
    return [t]


def test_make_batch_spec_matches_reference(runs):
    ref = runs[0]
    for name, (arch, shape, axes) in SPEC_CASES.items():
        ctx = sh.make_ctx(_cfg(arch), sh.AbstractMesh(shape, axes))
        specs, shardings = trainer.make_batch_spec(_cfg(arch), ctx, 8, 32)
        want = ref["specs"][name]
        assert sorted(specs) == sorted(want), name
        for k, (shp, dt, spec) in want.items():
            assert specs[k].shape == shp, (name, k)
            assert str(specs[k].dtype).replace("torch.", "") == dt, (name, k)
            assert shardings[k] == spec, (name, k, shardings[k], spec)


@pytest.mark.parametrize("compress", [0, 1])
def test_launch_train_production_mesh_matches_one_rank(runs, compress):
    """``launch.train --production-mesh`` with ``REPRO_TEST_MESH=1x2`` on
    two gloo ranks against the same run on one process; its sharded
    checkpoints are one-rank checkpoints."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import train as train_mod

    _, ranks, d = runs
    with tempfile.TemporaryDirectory() as t:
        want = train_mod.main(TRAIN_ARGS + ["--ckpt", t] + (
            ["--compress-grads"] if compress else []))
        one = ckpt.load_flat(t, 3)
    for r in ranks[:2]:
        np.testing.assert_allclose(r["launch"][compress], want, rtol=TOL)
    two = ckpt.load_flat(str(d / f"l{compress}"), 3)
    assert sorted(one) == sorted(two)
    for k in one:
        assert one[k].shape == two[k].shape, k


def test_one_rank_mesh_is_the_unsharded_step_bit_for_bit():
    """A (1, 1) mesh runs every mesh path as the identity: its step is
    ``ctx=None``'s bit for bit."""
    cfg = _cfg("qwen2-moe-a2.7b")
    ctx = sh.make_ctx(cfg, sh.AbstractMesh((1, 1), ("data", "model"),
                                           (0, 0)), fsdp=True)
    batch = dict(tokens=torch.as_tensor(_tokens(cfg)))
    out = []
    for c in (None, ctx):
        model = tfm.init_model(cfg, torch.Generator().manual_seed(SEED),
                               "cpu", ctx=c)
        o = opt_mod.adafactor(opt_mod.cosine_schedule(LR, *SCHED),
                              stacks=trainer.stacked_leaves(model))
        st = o.init(trainer.trainable_params(model))
        _, st, met = trainer.make_train_step(cfg, c, o)(model, st, batch)
        out.append((met, dict(model.named_parameters())))
    (m0, p0), (m1, p1) = out
    assert torch.equal(m0["loss"], m1["loss"])
    assert torch.equal(m0["gnorm"], m1["gnorm"])
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k


if __name__ == "__main__":
    if sys.argv[1] == "--reference":
        reference(sys.argv[2], int(sys.argv[3]))
    elif sys.argv[1] == "--rank":
        _rank(*map(int, sys.argv[2:6]), *sys.argv[6:8])
