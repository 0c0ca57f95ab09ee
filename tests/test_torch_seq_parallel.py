"""Sequence parallelism (``seq`` on ``model``) in training and prefill on
the CPU, held against the reference's mesh step and the port's own step
without it.

The port runs in four gloo ranks on 127.0.0.1 (``--rank``), a process
each, over a 2 x 2 device mesh: the (2, 2) cases on all four, the (1, 2)
cases on its two ``model`` rows (``SubMesh``). Each rank draws the whole
leaves from the same seed and keeps its shards; a float32 step's
gradients (after ``reduce_gradients``, which sums the ``seq_partial``
leaves over ``model``) are gathered whole. The families: Qwen2-1.5B,
RecurrentGemma-2B (a cycle), RWKV6-3B and Qwen1.5-MoE-A2.7B in
``"tensor"`` and ``"expert"`` modes, reduced, at B 4 x S 16.

The reference's side is stored (``tests/data/torch_seq_parallel_
expected.json``, written by ``PYTHONPATH=src python
tests/test_torch_seq_parallel.py --reference``, about 40 s with four
forced host devices): for each case its loss, aux, gradient norm and,
for each gradient leaf, its norm, four seeded Gaussian projections and,
for leaves of at most ``SMALL`` elements (the norms, biases, RWKV6's
shift mixes and bonus, the router), every element. The whole leaves
would be 5.6 MB. Bars, those of ``tests/test_torch_mesh_train.py``:
the loss, aux and gnorm within 1e-5 relative, every leaf within 1e-5 of
its norm against the step without sequence parallelism (the whole
leaf), and against the reference what that bar implies of what is
stored: the small leaves whole, a large leaf's norm within 1e-5 of it
and each projection within 1e-5 of the leaf's norm times the probe's
(Cauchy-Schwarz). RWKV6 follows that file's rule: what the mesh changes
against the step with no mesh is held to what it changes in the
reference, each leaf within the bar, ``mix.u`` at ``LOOSE_FACTOR`` times
it.

Reference facts (measured when the file was written):

- The reference's sequence-parallel step runs for every family here, and
  for the dense ones equals its step without a mesh within 6.4e-7 of the
  gradient's norm.
- For the MoE it does not: its ``shard_map`` cuts the sequence over
  ``model`` too, routes each slice alone and sums the ranks' outputs for
  different tokens, 2.9 % of the gradient's norm off its own step
  without a mesh (``reference_sp`` in the file). The port gathers the
  sequence into the MoE layer instead, so its MoE cases are held to the
  reference's step on the same mesh without sequence parallelism (the
  per-data-shard routing of ``tests/test_torch_mesh_train.py``), and at
  (1, 2) to its own step with no mesh, at (2, 2) to its own step without
  sequence parallelism.

Prefill: logits and caches under sequence parallelism equal the
tensor-parallel prefill's within float32 tolerance, and a decode step
raises. Collectives: a forward under sequence parallelism runs no sum
where tensor parallelism runs one: each becomes a reduce-scatter, and
each block's entry a gather (the embedding's sum has no entry); a block
that runs whole on every rank (replicated heads, or a mix whose heads or
hidden units are whole), which ran no collective, gathers at its entry
and keeps its slice; and the final hidden state is gathered once
(``COUNT_RULE``).
"""
import base64
import dataclasses
import json
import os
import socket
import subprocess
import sys
import zlib
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
EXPECTED = ROOT / "tests" / "data" / "torch_seq_parallel_expected.json"
B, S, SEED, LR = 4, 16, 1, 1e-3
TOL = 1e-5
LOOSE_LEAVES = ("/mix/u",)
LOOSE_FACTOR = 4.0
SMALL = 1024                    # leaves stored whole
PROBES = 4
SPAWN_TIMEOUT = 300
TENSOR, EXPERT = dict(moe_sharding="tensor"), dict(moe_sharding="expert")
FAMILIES = {"qwen2": ("qwen2-1.5b", {}),
            "recurrentgemma": ("recurrentgemma-2b", {}),
            "rwkv6": ("rwkv6-3b", {}),
            "moe tensor": ("qwen2-moe-a2.7b", TENSOR),
            "moe expert": ("qwen2-moe-a2.7b", EXPERT)}
SHAPES = ((1, 2), (2, 2))
CASES = {f"{fam} {d}x{m}": (fam, (d, m)) for fam in FAMILIES
         for d, m in SHAPES}
NO_MESH_FAMILIES = ("rwkv6",)   # held by what the mesh changes
MOE = ("moe tensor", "moe expert")
# a forward's collectives by kind under sequence parallelism, from the
# same forward's under tensor parallelism
COUNT_RULE = ("sp: sum = 0, reduce_scatter = tp sum, gather = tp gather "
              "+ tp sum + blocks run whole")


def _cfg(fam, reference=False):
    arch, rep = FAMILIES[fam]
    if reference:
        from repro.configs import get_config as g, reduced as r
    else:
        g, r = get_config, reduced
    return dataclasses.replace(r(g(arch)), **rep)


def _tokens(cfg):
    from repro_torch.data import SyntheticTokenPipeline
    return SyntheticTokenPipeline(cfg.vocab_size, B, S, seed=3
                                  ).batch_at(0)["tokens"]


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k],
                                                       f"{path}/{k}")]
    return [(path, np.asarray(tree, np.float64))]


def _probes(path, n):
    rng = np.random.default_rng(zlib.crc32(path.encode()))
    return rng.standard_normal((PROBES, n))


def summary(tree) -> dict:
    """Each leaf's norm, projections and, if small, its elements."""
    out = {}
    for path, a in _flat(tree):
        e = dict(norm=float(np.linalg.norm(a)),
                 proj=(_probes(path, a.size) @ a.ravel()).tolist())
        if a.size <= SMALL:
            e["full"] = base64.b64encode(
                a.astype("<f4").tobytes()).decode()
        out[path] = e
    return out


# ---------------------------------------------------------------------------
# the reference, offline
# ---------------------------------------------------------------------------


def reference() -> dict:
    """What the JSON file holds (four host devices, set before JAX
    starts)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.distributed.sharding import make_ctx
    from repro.train import trainer as rtrainer

    opts = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}

    def step(cfg, ctx, params, batch, m=None):
        fn = jax.value_and_grad(lambda p, b: rtrainer.loss_fn(p, b, cfg, ctx),
                                has_aux=True)
        jitted = jax.jit(fn).lower(params, batch).compile(
            compiler_options=opts)
        if m is None:
            (loss, parts), g = jitted(params, batch)
        else:
            with m:
                (loss, parts), g = jitted(params, batch)
        return float(loss), float(parts["aux"]), jax.tree.map(np.asarray, g)

    def gnorm(g):
        return float(np.sqrt(sum(np.sum(a ** 2) for _, a in _flat(g))))

    out = {"about": "The reference's float32 mesh steps (loss, aux, "
                    "gradient norm and per-leaf summaries) on the cases of "
                    "tests/test_torch_seq_parallel.py; written by it with "
                    "--reference", "cases": {}, "no_mesh": {}}
    nones = {}
    for name, (fam, shape) in CASES.items():
        cfg, pcfg = _cfg(fam, reference=True), _cfg(fam)
        params = jax.tree.map(jnp.asarray, params_to_reference(
            tfm.init_model(pcfg, torch.Generator().manual_seed(SEED), "cpu"),
            pcfg))
        batch = dict(tokens=jnp.asarray(_tokens(pcfg)))
        n = int(np.prod(shape))
        m = Mesh(np.array(jax.devices()[:n]).reshape(shape),
                 ("data", "model"))
        sp = fam not in MOE
        loss, aux, g = step(cfg, make_ctx(cfg, m, seq_parallel=sp), params,
                            batch, m)
        row = dict(seq_parallel=sp, loss=loss, aux=aux, gnorm=gnorm(g),
                   grads=summary(g))
        if fam not in out["no_mesh"]:
            l0, a0, g0 = step(cfg, None, params, batch)
            out["no_mesh"][fam] = dict(loss=l0, aux=a0, gnorm=gnorm(g0),
                                       grads=summary(g0))
            nones[fam] = g0
        if not sp:
            ls, as_, gs = step(cfg, make_ctx(cfg, m, seq_parallel=True),
                               params, batch, m)
            diff = np.sqrt(sum(np.sum((a - b) ** 2) for (_, a), (_, b) in
                               zip(_flat(gs), _flat(nones[fam]))))
            row["reference_sp"] = dict(loss=ls, aux=as_,
                                       grad_rel_vs_no_mesh=float(
                                           diff / gnorm(nones[fam])))
        out["cases"][name] = row
    return out


# ---------------------------------------------------------------------------
# a rank
# ---------------------------------------------------------------------------


class SubMesh:
    """A ``("data", "model")`` mesh over one row (1, 2) of a 2 x 2
    ``DeviceMesh``: its shape, this rank's coordinate and the row's
    process group, as ``ShardCtx`` reads them."""
    mesh_dim_names = ("data", "model")
    shape = (1, 2)

    def __init__(self, full):
        self.full = full
        self.coordinate = [0, full.get_coordinate()[1]]

    def get_coordinate(self):
        return self.coordinate

    def get_group(self, axis):
        return self.full.get_group(axis)


def _step(fam, ctx):
    """A float32 step: (loss, aux, AdamW's gnorm, whole gradients)."""
    cfg = _cfg(fam)
    model = tfm.init_model(cfg, torch.Generator().manual_seed(SEED), "cpu",
                           ctx=ctx)
    params = trainer.trainable_params(model)
    batch = trainer.local_batch(dict(tokens=torch.as_tensor(_tokens(cfg))),
                                ctx)
    (loss, parts), grads = trainer.value_and_grad(model, batch, cfg, ctx)
    grads = trainer.reduce_gradients(grads, params, ctx)
    o = opt_mod.adamw(opt_mod.cosine_schedule(LR, 2, 10))
    _, _, met = o.update(grads, o.init(params), params, ctx=ctx)
    if ctx is not None:
        grads = {k: sh.NamedSharding(ctx, params[k].axes).gather(v)
                 for k, v in grads.items()}
    return dict(loss=float(loss), aux=float(parts["aux"]),
                gnorm=float(met["gnorm"]),
                grads=params_to_reference(model, cfg, grads))


def _prefill(fam, ctx):
    """A prefill's hidden state, last logits and cache shards under
    ``ctx``, and its collectives by kind."""
    from repro_torch.distributed.collectives import counts, reset_counts

    cfg = _cfg(fam)
    model = tfm.init_model(cfg, torch.Generator().manual_seed(SEED), "cpu",
                           ctx=ctx)
    tokens = ctx.local(torch.as_tensor(_tokens(cfg))[:, :S], ("batch", None))
    cache = tfm.init_cache(cfg, B, 2 * S, dtype=torch.float32, device="cpu",
                           ctx=ctx)
    positions = torch.arange(S, dtype=torch.int32).expand(tokens.shape[0], S)
    reset_counts()
    with torch.inference_mode():
        hidden, cache, _ = tfm.forward(model, tokens=tokens,
                                       positions=positions, cache=cache,
                                       t=0, mode="prefill")
    kinds = {k: v["calls"] for k, v in counts().items()}
    with torch.inference_mode():
        logits = tfm.logits_fn(model, hidden[:, -1:])
    out = dict(hidden=hidden, logits=logits, cache=cache, counts=kinds,
               whole=_whole_blocks(model))
    if ctx.sharded("seq"):
        from repro_torch.runtime.serve import make_decode_step
        try:
            make_decode_step(cfg, ctx)(model, tokens[:, -1:], cache, S)
            out["decode"] = None
        except ValueError as e:
            out["decode"] = str(e)
    return out


def _whole_blocks(model) -> int:
    """The attention blocks and recurrent mixes that run whole on every
    rank of ``model``: no collective under tensor parallelism, a gather
    under sequence parallelism."""
    n = 0
    for layer in model.layers:
        if isinstance(layer, tfm.AttentionBlock):
            n += not layer.shard.act
        elif isinstance(layer, tfm.RGLRUBlock):
            n += layer.lru.ctx is None
        else:
            n += (layer.mix.heads_ctx is None) + (layer.mix.ff_ctx is None)
    return n


def _rank(rank, world, port, out):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    full = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    meshes = {(2, 2): full, (1, 2): SubMesh(full)}
    data = full.get_coordinate()[0]
    report = {"steps": {}, "tp": {}, "none": {}, "prefill": {}}
    for i, (name, (fam, shape)) in enumerate(CASES.items()):
        if shape == (1, 2) and (i // 2) % 2 != data:
            continue
        cfg = _cfg(fam)
        ctx = sh.make_ctx(cfg, meshes[shape], seq_parallel=True)
        got = _step(fam, ctx)
        tp = (_step(fam, sh.make_ctx(cfg, meshes[shape]))
              if fam in MOE and shape == (2, 2) else None)
        if ctx.index("data") == 0 and ctx.index("model") == 0:
            report["steps"][name] = got
            if tp is not None:
                report["tp"][name] = tp
    for i, fam in enumerate(FAMILIES):
        if i % world == rank:
            report["none"][fam] = _step(fam, None)
        if i % 2 == data:
            cfg = _cfg(fam)
            row = meshes[(1, 2)]
            got = {sp: _prefill(fam, sh.make_ctx(cfg, row, seq_parallel=sp))
                   for sp in (False, True)}
            if full.get_coordinate()[1] == 0:
                report["prefill"][fam] = got
    dist.destroy_process_group()
    torch.save(report, out)


# ---------------------------------------------------------------------------
# the runs
# ---------------------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq_parallel")
    port = _free_port()
    outs = [tmp / f"rank{r}.pt" for r in range(4)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r),
                               "4", str(port), str(outs[r])], env=env,
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(4)]
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
    return [torch.load(o, weights_only=False) for o in outs]


@pytest.fixture(scope="module")
def expected():
    return json.loads(EXPECTED.read_text())


def _one(ranks, key, name):
    got = [r[key][name] for r in ranks if name in r[key]]
    assert len(got) == 1, (key, name, len(got))
    return got[0]


def _loose(path):
    return LOOSE_FACTOR if path.endswith(LOOSE_LEAVES) else 1.0


def _close(got, want, what, tol):
    err = np.linalg.norm(np.asarray(got, np.float64)
                         - np.asarray(want, np.float64))
    assert err <= tol * max(np.linalg.norm(want), 1e-30), (
        what, err, np.linalg.norm(want))


def _held_to_summary(got_tree, want, what, base_tree=None, base=None):
    """Every leaf of ``got_tree`` against a stored summary, by what the
    bar implies of it; with ``base_tree`` and ``base`` (the steps with no
    mesh), what the mesh changes against what it changes there."""
    got = dict(_flat(got_tree))
    ref_base = dict(_flat(base_tree)) if base_tree is not None else None
    assert sorted(got) == sorted(want), what
    for path, e in want.items():
        tol = TOL * _loose(path) if base is not None else TOL
        g = got[path].ravel()
        probes = _probes(path, g.size)
        norm, proj = e["norm"], np.asarray(e["proj"])
        if base is not None:     # the changes, each side's own
            g = g - ref_base[path].ravel()
            proj = proj - np.asarray(base[path]["proj"])
        if "full" in e:
            w = np.frombuffer(base64.b64decode(e["full"]), "<f4").astype(
                np.float64)
            if base is not None:
                w = w - np.frombuffer(base64.b64decode(base[path]["full"]),
                                      "<f4")
            assert np.linalg.norm(g - w) <= tol * max(norm, 1e-30), (
                what, path, np.linalg.norm(g - w), norm)
            continue
        if base is None:
            assert abs(np.linalg.norm(g) - norm) <= tol * norm, (what, path)
        bound = tol * norm * np.linalg.norm(probes, axis=1)
        assert np.all(np.abs(probes @ g - proj) <= bound), (
            what, path, np.abs(probes @ g - proj), bound)


@pytest.mark.parametrize("name", list(CASES))
def test_sp_step_matches_reference_mesh_step(ranks, expected, name):
    fam, _ = CASES[name]
    want = expected["cases"][name]
    assert want["seq_parallel"] == (fam not in MOE)
    got = _one(ranks, "steps", name)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL)
    np.testing.assert_allclose(got["aux"], want["aux"], rtol=TOL, atol=1e-7)
    np.testing.assert_allclose(got["gnorm"], want["gnorm"], rtol=TOL)
    if fam in NO_MESH_FAMILIES:
        _held_to_summary(got["grads"], want["grads"], name,
                         _one(ranks, "none", fam)["grads"],
                         expected["no_mesh"][fam]["grads"])
    else:
        _held_to_summary(got["grads"], want["grads"], name)


@pytest.mark.parametrize("name", list(CASES))
def test_sp_step_matches_step_without_sp(ranks, name):
    """Against the port's step with no mesh, or for the MoE at (2, 2),
    whose data shards route alone, its step on the mesh without sequence
    parallelism: the whole of every leaf."""
    fam, shape = CASES[name]
    got = _one(ranks, "steps", name)
    want = (_one(ranks, "tp", name) if fam in MOE and shape == (2, 2)
            else _one(ranks, "none", fam))
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL)
    np.testing.assert_allclose(got["aux"], want["aux"], rtol=TOL, atol=1e-7)
    np.testing.assert_allclose(got["gnorm"], want["gnorm"], rtol=TOL)
    wants = dict(_flat(want["grads"]))
    for path, g in _flat(got["grads"]):
        _close(g, wants[path], (name, path), TOL * _loose(path))


def test_reference_sp_moe_is_recorded_as_off_its_own_step(expected):
    """The reference fact the MoE cases rest on: its sequence-parallel
    MoE step moves by more than the bar against its step without a mesh,
    while its dense families' do not."""
    for name, (fam, _) in CASES.items():
        row = expected["cases"][name]
        if fam in MOE:
            assert row["reference_sp"]["grad_rel_vs_no_mesh"] > 1e-2, name
            assert "reference_sp" in row and not row["seq_parallel"]


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_sp_prefill_matches_tp_prefill(ranks, fam):
    """At (1, 2): the hidden state, the last token's logits over the
    whole vocab and every cache shard within float32 tolerance of the
    tensor-parallel prefill's."""
    run = _one(ranks, "prefill", fam)
    tp, sp = run[False], run[True]
    for key in ("hidden", "logits"):
        np.testing.assert_allclose(sp[key], tp[key], rtol=1e-5, atol=1e-5,
                                   err_msg=key)
    assert len(sp["cache"]) == len(tp["cache"])
    for i, (a, b) in enumerate(zip(sp["cache"], tp["cache"])):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].shape == b[k].shape, (i, k)
            np.testing.assert_allclose(a[k].float(), b[k].float(),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"layer {i} {k}")


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_sp_decode_step_raises(ranks, fam):
    """A decode step's one token does not divide over the two ``model``
    ranks: ``ValueError`` naming the length and the axis size, as the
    reference's jit refuses the (B, 1) token's sharding."""
    msg = _one(ranks, "prefill", fam)[True]["decode"]
    assert msg is not None and "length 1" in msg and "2 ranks" in msg


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_sp_collectives_follow_the_count_rule(ranks, fam):
    run = _one(ranks, "prefill", fam)
    tp, sp = run[False]["counts"], run[True]["counts"]
    assert tp.get("sum", 0) > 0 and "reduce_scatter" not in tp, tp
    assert sp.get("sum", 0) == 0, (COUNT_RULE, sp)
    assert sp.get("reduce_scatter", 0) == tp["sum"], (COUNT_RULE, tp, sp)
    whole = run[True]["whole"]
    assert sp.get("gather", 0) == tp.get("gather", 0) + tp["sum"] + whole, (
        COUNT_RULE, tp, sp, whole)
    assert sp.get("mean", 0) == tp.get("mean", 0)


if __name__ == "__main__":
    if sys.argv[1] == "--reference":
        os.environ.setdefault("XLA_FLAGS",
                              "--xla_force_host_platform_device_count=4")
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        EXPECTED.parent.mkdir(exist_ok=True)
        EXPECTED.write_text(json.dumps(reference(), indent=1) + "\n")
        print(f"wrote {EXPECTED}")
    elif sys.argv[1] == "--rank":
        _rank(*map(int, sys.argv[2:5]), sys.argv[5])
