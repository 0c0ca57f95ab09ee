"""The port's dry run (``repro_torch/launch/dryrun.py``) on fake tensors over
a fake process group, held against the reference's (``repro/launch/
dryrun.py``), and the kernels' FLOP formulas against their plain versions.

Host policy, exact: for all configs, the four shapes, the pod and
multipod meshes, both ``--fsdp-mode``s and ``seq_parallel`` off and on,
the port's ``_make_ctx_for(...).rules``, ``pick_optimizer``'s kind and
FSDP flag, ``shape_applicable``'s skips and ``parse_overrides`` equal the
reference's, computed in one JAX child with 512 forced host devices and
a ``jax.sharding.Mesh`` (``--policy``). Per-rank shapes: for each config
on the CI mesh (2 x 4), every leaf's local shape of the parameters (the
port's built model), the optimizer state (its template), each serving
shape's cache and every shape's inputs equals what the reference's
shardings give (``NamedSharding.shard_shape``). Nothing is compiled.

The reference's numbers on five cells are stored
(``tests/data/torch_dryrun_expected.json``, written by ``PYTHONPATH=src
python tests/test_torch_dryrun.py --reference``, about 3 minutes: it
patches ``make_production_mesh`` in its own process to build a
``jax.sharding.Mesh``, whose Auto axes the reference's sharding
constraints need, under ``REPRO_TEST_MESH=2x4``). The port's
``run_cell`` runs on them in a child (``--port``: every cell joins its
own fake process group, which is process-global) and must give:

- ``status`` ok, and ``error`` for sequence-parallel decode, as the
  reference;
- ``argument_bytes`` equal to the reference's; a decode cell's differ by
  ``DECODE_T_BYTES``, the position ``t`` that the reference's step takes
  as an int32 array and the port's as a Python int;
- ``analysis.flops`` within ``FLOP_BAR`` of the reference's. The port
  counts matrix products and the kernels' formulas (attention as dense
  S^2, as the reference's dense variant); XLA also counts elementwise
  work. In the training cells that is a small share (the measured gaps:
  +0.48 % Qwen2-1.5B, -1.2 % with sequence parallelism, -0.84 % RWKV6-3B,
  -0.79 % Qwen1.5-MoE-A2.7B). In the decode cell it is most of XLA's
  count: the reference's decode converts every slot of the KV cache to
  float32 and writes the new one by a select over the whole cache, each
  layer, which the port's decode kernel does not do; that cell is held to
  the reference's matrix products alone (``dot_flops``, parsed from its
  HLO at the same two depths) within the same bar.
- collective bytes by kind, recorded beside the reference's.

The FakeTensorMode case of the cross-entropy: its backward, with the
vocab split over ``model``, traces with no ``ShapeEnv``.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.distributed.sharding import AbstractMesh
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]
EXPECTED = ROOT / "tests" / "data" / "torch_dryrun_expected.json"
# name: (arch, shape, overrides, seq_parallel)
CELLS = {
    "qwen2 decode": ("qwen2-1.5b", "decode_32k", {}, False),
    "qwen2 decode sp": ("qwen2-1.5b", "decode_32k", {}, True),
    "qwen2 train": ("qwen2-1.5b", "train_4k", {"n_layers": 2}, False),
    "qwen2 train sp": ("qwen2-1.5b", "train_4k", {"n_layers": 2}, True),
    "rwkv6 train": ("rwkv6-3b", "train_4k", {"n_layers": 2}, False),
    "moe train": ("qwen2-moe-a2.7b", "train_4k", {"n_layers": 2}, False),
}
FLOP_BAR = 0.02
DECODE_T_BYTES = 4
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
CI_MESH = ((2, 4), ("data", "model"))
OVERRIDE_PAIRS = ["n_layers=2", "remat=false", "capacity_factor=1.25",
                  "moe_dispatch=ragged", "scan_layers=1", "dtype=float32"]
SPAWN_TIMEOUT = 600


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1", **extra)
    env.pop("REPRO_TEST_MESH", None)
    env.update(extra)
    return env


def _child(args, **env):
    p = subprocess.run([sys.executable, __file__, *args], env=_env(**env),
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=SPAWN_TIMEOUT)
    assert p.returncode == 0, (p.stdout + p.stderr)[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def _norm(v):
    """Rules and specs as JSON holds them (tuples as lists)."""
    return json.loads(json.dumps(v))


# ---------------------------------------------------------------------------
# the reference, in children
# ---------------------------------------------------------------------------


def reference_policy() -> dict:
    """The reference's host policy and CI-mesh shard shapes (512 host
    devices, set by the caller)."""
    import jax
    from jax.sharding import Mesh, NamedSharding
    from repro.configs import SHAPES as RSHAPES
    from repro.configs import get_config as rget
    from repro.configs import shape_applicable
    from repro.distributed.sharding import spec_tree
    from repro.launch import dryrun as rd
    from repro.models import transformer as rtfm

    def mesh(shape, axes):
        n = int(np.prod(shape))
        return Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)

    meshes = {k: mesh(*v) for k, v in MESHES.items()}
    out = {"rules": {}, "optimizer": {}, "applicable": {}, "shards": {},
           "overrides": rd.parse_overrides(OVERRIDE_PAIRS),
           "rwkv_step_flops": {}}
    for arch in list_configs():
        cfg = rget(arch)
        opt, fsdp = rd.pick_optimizer(cfg)
        out["optimizer"][arch] = [opt.update.__qualname__.split(".")[0],
                                  fsdp]
        for sname, shape in RSHAPES.items():
            ok, why = shape_applicable(cfg, shape)
            out["applicable"][f"{arch} {sname}"] = [ok, why]
            for mname, m in meshes.items():
                for mode in ("always", "train-only"):
                    for sp in (False, True):
                        ctx = rd._make_ctx_for(cfg, m, shape, mode, sp)
                        out["rules"][f"{arch} {sname} {mname} {mode} {sp}"] \
                            = _norm(ctx.rules)
        out["shards"][arch] = _reference_shards(cfg, mesh(*CI_MESH), rd,
                                                rtfm, spec_tree,
                                                NamedSharding, RSHAPES)
    for B, H, hd in ((2, 3, 16), (1, 2, 32)):
        c = dataclasses.replace(rget("rwkv6-3b"), rwkv_head_dim=hd)
        out["rwkv_step_flops"][f"{B} {H} {hd}"] = rd._rwkv_step_flops(c, B, H)
    return out


def _leaf_shapes(tree, specs, mesh, named, path=""):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _leaf_shapes(
            tree[key], specs[key], mesh, named, f"{path}/{key}").items()}
    return {path: list(named(mesh, specs).shard_shape(tuple(tree.shape)))}


def _reference_shards(cfg, m, rd, rtfm, spec_tree, named, shapes):
    """Local shapes on the CI mesh: params, optimizer state, each serving
    shape's cache, each shape's inputs."""
    out = {}
    for sname, shape in shapes.items():
        ctx = rd._make_ctx_for(cfg, m, shape)
        tmpl = rtfm.model_template(cfg)
        if shape.kind == "train":
            out["params"] = _leaf_shapes(tmpl, spec_tree(tmpl, ctx), m,
                                         named)
            ot = rd.pick_optimizer(cfg)[0].state_template(tmpl)
            out["optimizer"] = _leaf_shapes(ot, spec_tree(ot, ctx), m,
                                            named)
        else:
            ct = rtfm.cache_template(cfg, shape.global_batch, shape.seq_len)
            out[f"cache {sname}"] = _leaf_shapes(ct, spec_tree(ct, ctx), m,
                                                 named)
        for sp in (False, True):
            ctx = rd._make_ctx_for(cfg, m, shape, seq_parallel=sp)
            specs, shard = rd.input_specs(cfg, shape, ctx)
            out[f"inputs {sname} {sp}"] = {
                k: _shard_shape(shard[k], v.shape) for k, v in specs.items()}
    return out


def _shard_shape(sharding, shape):
    """The shard's shape, or "indivisible" where a dim does not divide
    (a decode token's one position over ``model``)."""
    try:
        return list(sharding.shard_shape(tuple(shape)))
    except ValueError:
        return "indivisible"


def _dot_flops(hlo: str) -> float:
    """2 x output elements x contracted size, summed over the HLO's dot
    instructions (operand shapes looked up by name)."""
    shapes = {}
    for m in re.finditer(r"%([\w.\-]+) = \w+\[([0-9,]*)\]", hlo):
        shapes[m.group(1)] = [int(x) for x in m.group(2).split(",") if x]
    total = 0.0
    for m in re.finditer(r"= \w+\[([0-9,]*)\]\S* dot\(%([\w.\-]+), "
                         r"%[\w.\-]+\), lhs_batch_dims=\{[0-9,]*\}, "
                         r"lhs_contracting_dims=\{([0-9,]*)\}|"
                         r"= \w+\[([0-9,]*)\]\S* dot\(%([\w.\-]+), "
                         r"%[\w.\-]+\), lhs_contracting_dims=\{([0-9,]*)\}",
                         hlo):
        out, lhs, dims = ((m.group(1), m.group(2), m.group(3))
                          if m.group(2) else
                          (m.group(4), m.group(5), m.group(6)))
        n = int(np.prod([int(x) for x in out.split(",") if x]))
        k = int(np.prod([shapes[lhs][int(d)] for d in dims.split(",")
                         if d]))
        total += 2.0 * n * k
    return total


def reference_cells() -> dict:
    """The reference's dry run of CELLS on a (2, 4) mesh of host devices
    (set by the caller), with its matrix products' FLOPs beside."""
    import jax
    from jax.sharding import Mesh
    from repro.configs import SHAPES as RSHAPES
    from repro.configs import get_config as rget
    from repro.launch import dryrun as rd

    def make_mesh(multi_pod=False):
        shape, axes = ((2, 2, 4), ("pod", "data", "model")) if multi_pod \
            else CI_MESH
        n = int(np.prod(shape))
        return Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)

    rd.make_production_mesh = make_mesh       # this process only
    out = {"about": "The reference's dry run (src/repro/launch/dryrun.py) "
                    "of the cells of tests/test_torch_dryrun.py at "
                    "REPRO_TEST_MESH=2x4; written by it with --reference",
           "cells": {}}
    for name, (arch, sname, ov, sp) in CELLS.items():
        try:
            r = rd.run_cell(arch, sname, "pod", overrides=ov or None,
                            seq_parallel=sp)
        except Exception as e:  # noqa: BLE001 — main() records it so
            out["cells"][name] = dict(status="error",
                                      error=f"{type(e).__name__}: {e}")
            continue
        cfg = dataclasses.replace(rget(arch), **ov)
        shape, m = RSHAPES[sname], make_mesh()
        p = len(cfg.block_pattern)
        L1 = cfg.first_k_dense + p
        dots = []
        for L in (L1, L1 + p):
            c2 = dataclasses.replace(cfg, n_layers=L, scan_layers=False,
                                     analysis_mode=True)
            ctx = rd._make_ctx_for(c2, m, shape, "always", sp)
            dots.append(_dot_flops(rd._lower_cell(c2, shape, ctx, m)
                                   .compile().as_text()))
        out["cells"][name] = dict(
            status=r["status"], hlo_gflops=r["hlo_gflops"],
            argument_bytes=r["memory"]["argument_bytes"],
            peak_bytes=r["memory"]["peak_bytes"],
            flops=r["analysis"]["flops"],
            dot_flops=dots[0] + (dots[1] - dots[0]) / p * (
                cfg.n_layers - L1),
            collectives=r["analysis"]["collectives"])
    return out


# ---------------------------------------------------------------------------
# the port's cells, in a child
# ---------------------------------------------------------------------------


def port_cells() -> dict:
    out = {"cells": {}}
    for name, (arch, sname, ov, sp) in CELLS.items():
        try:
            r = dryrun.run_cell(arch, sname, "pod", overrides=ov or None,
                                seq_parallel=sp)
        except Exception as e:  # noqa: BLE001 — main() records it so
            r = dict(status="error", error=f"{type(e).__name__}: {e}")
        out["cells"][name] = r
    out["ce"] = _fake_ce()
    from repro_torch.kernels import launch_counts
    out["launches"] = launch_counts()
    return out


def _fake_ce() -> dict:
    """The vocab-parallel cross-entropy's forward and backward under
    ``FakeTensorMode`` with no ``ShapeEnv``, the vocab split over a
    ``model`` axis of 4 fake ranks."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.distributed.sharding import make_ctx
    from repro_torch.train.losses import vocab_parallel_ce

    mesh = dryrun.join_fake_mesh()
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), vocab_size=500)
    ctx = make_ctx(cfg, mesh)
    with FakeTensorMode() as mode:
        assert mode.shape_env is None
        h = torch.zeros(2, 8, 64, requires_grad=True)
        w = torch.zeros(64, 128, requires_grad=True)
        labels = torch.zeros(2, 8, dtype=torch.int64)
        loss = vocab_parallel_ce(h, w, labels, cfg, ctx)
        dh, dw = torch.autograd.grad(loss, (h, w))
    return dict(loss=list(loss.shape), dh=list(dh.shape), dw=list(dw.shape))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def policy():
    return _child(["--policy"], JAX_PLATFORMS="cpu",
                  XLA_FLAGS="--xla_force_host_platform_device_count=512")


@pytest.fixture(scope="module")
def port():
    return _child(["--port"], REPRO_TEST_MESH="2x4")


@pytest.fixture(scope="module")
def expected():
    return json.loads(EXPECTED.read_text())


def test_host_policy_matches_reference(policy):
    from repro_torch.configs import shape_applicable

    for arch in list_configs():
        cfg = get_config(arch)
        _, kind, fsdp = dryrun.pick_optimizer(cfg)
        assert [kind, fsdp] == policy["optimizer"][arch], arch
        for sname, shape in SHAPES.items():
            assert list(shape_applicable(cfg, shape)) == \
                policy["applicable"][f"{arch} {sname}"], (arch, sname)
            for mname, (mshape, axes) in MESHES.items():
                m = AbstractMesh(mshape, axes)
                for mode in ("always", "train-only"):
                    for sp in (False, True):
                        key = f"{arch} {sname} {mname} {mode} {sp}"
                        got = dryrun._make_ctx_for(cfg, m, shape, mode, sp)
                        assert _norm(got.rules) == policy["rules"][key], key
    assert dryrun.parse_overrides(OVERRIDE_PAIRS) == policy["overrides"]


def _port_shards(cfg):
    """The port's local shapes on the CI mesh, rank (0, 0), keyed as the
    reference's leaves (a stacked leaf's layers axis first)."""
    from repro_torch.interop import cache_map, param_map
    from repro_torch.models import transformer as tfm

    mesh = AbstractMesh(*CI_MESH, coordinate=(0, 0))
    out = {}

    def stacked(entries, r_of):
        d = {}
        for path, r, shape in entries:
            key = "/" + "/".join(path)
            d[key] = ([r_of(path)] + list(shape)) if r is not None \
                else list(shape)
        return d

    def reps(path):
        t = tfm.model_template(cfg)
        for k in path:
            t = t[k]
        return t.shape[0]

    for sname, shape in SHAPES.items():
        ctx = dryrun._make_ctx_for(cfg, mesh, shape)
        if shape.kind == "train":
            model = tfm.Transformer(cfg, "meta", ctx=ctx)
            out["params"] = stacked(
                [(p, r, model.get_parameter(n).shape)
                 for p, r, n in param_map(cfg) if r in (None, 0)], reps)
            tmpl = dryrun.pick_optimizer(cfg)[0](model).state_template(
                tfm.model_template(cfg))
            out["optimizer"] = {k: list(ctx.local_shape(t.shape, t.axes))
                                for k, t in _template_leaves(tmpl)}
        else:
            cache = tfm.init_cache(cfg, shape.global_batch, shape.seq_len,
                                   device="meta", ctx=ctx)
            ct = tfm.cache_template(cfg, shape.global_batch, shape.seq_len)

            def creps(path, ct=ct):
                t = ct
                for k in path:
                    t = t[k]
                return t.shape[0]
            out[f"cache {sname}"] = stacked(
                [(p, r, cache[layer][key].shape)
                 for p, r, layer, key in cache_map(cfg) if r in (None, 0)],
                creps)
        for sp in (False, True):
            ctx = dryrun._make_ctx_for(cfg, mesh, shape, seq_parallel=sp)
            specs, spec = dryrun.input_specs(cfg, shape, ctx)
            out[f"inputs {sname} {sp}"] = {
                k: _spec_shape(v.shape, spec[k], ctx)
                for k, v in specs.items()}
    return out


def _spec_shape(shape, spec, ctx):
    """A dim cut by each spec entry's mesh axes."""
    out = []
    for dim, entry in zip(shape, spec):
        for a in (() if entry is None else (entry,) if isinstance(entry, str)
                  else entry):
            if dim % ctx.size(a):
                return "indivisible"
            dim //= ctx.size(a)
        out.append(dim)
    return out


def _template_leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in tree for x in _template_leaves(tree[k],
                                                          f"{path}/{k}")]
    return [(path, tree)]


@pytest.mark.parametrize("arch", list_configs())
def test_per_rank_shapes_match_reference(policy, arch):
    want = policy["shards"][arch]
    got = _port_shards(get_config(arch))
    assert sorted(got) == sorted(want), arch
    for part in want:
        assert got[part] == want[part], (arch, part)


@pytest.mark.parametrize("name", list(CELLS))
def test_run_cell_matches_reference(port, expected, name):
    got, want = port["cells"][name], expected["cells"][name]
    assert got["status"] == want["status"], (got.get("error"), want)
    if want["status"] != "ok":
        # the sequence-parallel decode: the token's one position does not
        # divide over the model axis, in both
        assert "divid" in got["error"] and "divisible" in want["error"]
        return
    arch, sname, _, sp = CELLS[name]
    args = got["memory"]["argument_bytes"]
    if SHAPES[sname].kind == "decode":
        args += DECODE_T_BYTES
    assert args == want["argument_bytes"], (args, want["argument_bytes"])
    assert sum(got["memory"]["split"][k] for k in
               ("parameters", "optimizer", "inputs")) == \
        got["memory"]["argument_bytes"]
    flops = got["analysis"]["flops"]
    ref = want["dot_flops"] if SHAPES[sname].kind == "decode" \
        else want["flops"]
    assert abs(flops / ref - 1) <= FLOP_BAR, (flops, ref)
    assert got["hlo_gflops"] == flops / 1e9
    coll = got["collective_bytes"]
    assert coll["total"] > 0 and want["collectives"]["total"] > 0
    if sp:
        assert coll["reduce-scatter"] > 0 and coll["all-gather"] > 0
    assert got["memory"]["peak_bytes"] >= got["memory"]["argument_bytes"]
    assert got["device"] in ("cuda", "meta")


def test_cross_entropy_backward_traces_on_fake_tensors(port):
    assert port["ce"] == dict(loss=[], dh=[2, 8, 64], dw=[64, 128])


def test_dry_run_launches_nothing(port):
    assert not any(port["launches"].values()), port["launches"]


def _count(fn, *args, **kw):
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as m:
        fn(*args, **kw)
    return m.get_total_flops()


def _meta(*ts):
    return [t.to("meta") for t in ts]


def test_flash_attention_flop_formulas_are_the_plain_versions_counts():
    """Forward: the plain version's count (q k^T and p v over the dense
    S^2). Backward: the plain backward's count less the forward it runs
    again (autograd through ``attention_ref``)."""
    from repro_torch.kernels.flash_attention import ops, ref
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 24, 4, 16, generator=g)
    k, v = torch.randn(2, 24, 2, 16, generator=g), torch.randn(
        2, 24, 2, 16, generator=g)
    fwd = _count(ref.attention_ref, q, k, v)
    bwd = _count(ref.attention_bwd_ref, q, k, v, q)
    assert fwd == 4 * 2 * 4 * 24 * 24 * 16
    assert _count(ops.flash_attention_fwd, *_meta(q, k, v)) == fwd
    mq, mk, mv = _meta(q, k, v)
    out, lse = ops.flash_attention_fwd(mq, mk, mv)
    assert _count(ops.flash_attention_bwd, mq, mk, mv, out, lse, mq) == \
        bwd - fwd


def test_decode_attention_flop_formula_is_the_plain_versions_count():
    from repro_torch.kernels.decode_attention import ops, ref
    g = torch.Generator().manual_seed(0)
    args = (torch.randn(3, 4, 16, generator=g),
            torch.randn(3, 40, 2, 16, generator=g),
            torch.randn(3, 40, 2, 16, generator=g),
            torch.zeros(3, 40, dtype=torch.int32),
            torch.full((3,), 50, dtype=torch.int32))
    want = _count(ref.decode_attention_ref, *args)
    assert want == 4 * 3 * 4 * 40 * 16
    assert _count(ops.decode_attention, *_meta(*args)) == want


def test_rwkv6_flop_formulas_count_the_reference_s_correction(policy):
    """8 B S H hd^2 forward: the reference's ``_rwkv_step_flops`` (XLA's
    count of one step, elementwise work included) times S, which the
    plain version's matrix products are a quarter of; the backward twice
    that, as the reference's dry run counts a training step's scan three
    times."""
    from repro_torch.kernels.rwkv6_scan import ops, ref
    S = 6
    for key, step in policy["rwkv_step_flops"].items():
        B, H, hd = map(int, key.split())
        g = torch.Generator().manual_seed(0)
        r, k, v = (torch.randn(B, S, H, hd, generator=g) for _ in range(3))
        lw = -torch.rand(B, S, H, hd, generator=g)
        u, s0 = torch.randn(H, hd, generator=g), torch.zeros(B, H, hd, hd)
        assert _count(ref.rwkv6_scan_ref, r, k, v, lw, u, s0) * 4 == step * S
        margs = _meta(r, k, v, lw, u, s0)
        assert _count(ops.rwkv6_scan, *margs) == step * S
        _, _, ckpt = ops.rwkv6_scan_fwd(*margs)
        assert _count(ops.rwkv6_scan_bwd, *margs, ckpt, margs[0]) == \
            2 * step * S


def test_rglru_flop_formulas_count_its_elementwise_work():
    """2 B S R forward (h = a h + b: a multiply and an add) and 3 B S R
    backward; the plain versions are elementwise loops, which
    ``FlopCounterMode`` counts as none."""
    from repro_torch.kernels.rglru_scan import ops, ref
    B, S, R = 2, 7, 24
    g = torch.Generator().manual_seed(0)
    a, b = torch.rand(B, S, R, generator=g), torch.randn(B, S, R,
                                                         generator=g)
    h0 = torch.zeros(B, R)
    assert _count(ref.rglru_scan_ref, a, b, h0) == 0
    ma, mb, mh = _meta(a, b, h0)
    assert _count(ops.rglru_scan, ma, mb, mh) == 2 * B * S * R
    hs, _ = ops.rglru_scan(ma, mb, mh)
    assert _count(ops.rglru_scan_bwd, ma, mh, hs, hs) == 3 * B * S * R


if __name__ == "__main__":
    if sys.argv[1] == "--policy":
        print(json.dumps(reference_policy()))
    elif sys.argv[1] == "--port":
        print(json.dumps(port_cells()))
    elif sys.argv[1] == "--reference":
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        os.environ["REPRO_TEST_MESH"] = "2x4"
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        EXPECTED.parent.mkdir(exist_ok=True)
        EXPECTED.write_text(json.dumps(reference_cells(), indent=1) + "\n")
        print(f"wrote {EXPECTED}")
