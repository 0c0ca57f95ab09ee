"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step on fake
tensors over a fake process group. Counterpart of
``repro/launch/dryrun.py``.

Where the reference lowers and compiles each cell for 512 placeholder
host devices, the port joins a ``"fake"`` process group of the
production mesh's size as rank 0 (``launch/mesh.production_shape``,
which honours ``REPRO_TEST_MESH``), builds the model, the optimizer
state, the cache and the inputs under ``FakeTensorMode`` and runs the
cell's step (``make_train_step``, ``make_prefill_step`` or
``make_decode_step``) on them. Nothing is allocated and nothing is
launched: the kernels' operators have shape-only implementations
(``kernels/library.py``) and the fake group's collectives move nothing,
so a dry run needs no card. The tensors are fake ``cuda`` tensors where
PyTorch is built with CUDA; a build without it cannot record autograd on
them, and the trace then runs on ``meta`` tensors, which take the same
operators (the artifact's ``device``).

Each cell's artifact mirrors the reference's fields:

- ``memory.argument_bytes``: the rank's parameters, optimizer state and
  inputs or cache (its shards), at full depth; ``memory.split`` parts
  it into parameters, optimizer and inputs, and gives the rest of the
  peak (activations, gradients, temporaries) as ``activations``;
  ``memory.peak_bytes`` is ``MemTracker``'s peak over the step.
- ``analysis``: per-rank FLOPs (``FlopCounterMode``'s formulas, counted
  by ``flop_count``: the matrix products and the kernels' operators,
  attention counted as the dense S^2 the
  reference's dense-attention variant counts), collective bytes by the
  reference's kind names (each collective's result bytes on the rank, in
  the tensor's dtype, counted by ``collectives.mesh_collective`` as
  ``result_bytes``) and the peak, each traced at 1 and 2 cycles of the
  layer pattern and extrapolated linearly in depth, as the reference
  does: total(L) = f(L1) + (f(L2) - f(L1)) / cycle * (L - L1).
  ``hlo_gflops`` is the same FLOP count: the port has no scan body that
  is counted once.
- ``hlo_bytes_accessed``, ``lower_s`` and ``compile_s`` have no meaning
  without XLA: null, with ``trace_s`` the traces' wall time.
- A cell that raises is recorded ``status: "error"`` with its reason.

The default process group is process-global: each cell destroys it and
joins a new one of its mesh's size.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k \\
      --mesh pod [--seq-parallel]
  python -m repro_torch.launch.dryrun --all   # every cell, sequential
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import (SHAPES, get_config, list_configs,
                                 shape_applicable)
from repro_torch.distributed.sharding import make_ctx, mesh_shape
from repro_torch.launch.mesh import production_shape
from repro_torch.models import frontends
from repro_torch.models.common import torch_dtype
from repro_torch.runtime.serve import make_decode_step, make_prefill_step
from repro_torch.train.optimizer import adafactor, adamw, cosine_schedule
from repro_torch.train.trainer import (make_batch_spec, make_train_step,
                                       stacked_leaves, trainable_params)

OUT = "benchmarks/artifacts/dryrun_torch"
# collectives.mesh_collective's kinds under the reference's HLO names
KIND_NAMES = {"sum": "all-reduce", "max": "all-reduce", "mean": "all-reduce",
              "gather": "all-gather", "fsdp_gather": "all-gather",
              "reduce_scatter": "reduce-scatter"}


def pick_optimizer(cfg):
    """Memory policy (DESIGN.md §5): Adafactor + FSDP for the 1T MoE;
    AdamW (+FSDP over `data` for >=10B) otherwise. Returns (the
    optimizer's constructor, its kind, fsdp): Adafactor takes the model's
    stacked leaves, known only once the model is built."""
    n = cfg.param_counts()["total"]
    if n > 100e9:
        return (lambda model: adafactor(cosine_schedule(1e-4, 100, 10000),
                                        stacks=stacked_leaves(model)),
                "adafactor", True)
    return (lambda model: adamw(cosine_schedule(3e-4, 100, 10000)),
            "adamw", n > 10e9)


def input_specs(cfg, shape, ctx):
    """``BatchSpec(shape, dtype)`` stand-ins for every model input of this
    cell and their specs (one mesh axis, a tuple of them or None per
    dim)."""
    from repro_torch.train.trainer import BatchSpec

    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return make_batch_spec(cfg, ctx, B, S)
    if shape.kind == "prefill":
        if frontends.uses_embeds(cfg):
            return (dict(embeds=BatchSpec((B, S, cfg.d_model),
                                          torch_dtype(cfg.dtype))),
                    dict(embeds=ctx.spec(("batch", "seq", "act_embed"))))
        return (dict(tokens=BatchSpec((B, S), torch.int32)),
                dict(tokens=ctx.spec(("batch", "seq"))))
    # decode: one new token against a seq_len KV cache
    if frontends.uses_embeds(cfg):
        return (dict(token=BatchSpec((B, 1, cfg.d_model),
                                     torch_dtype(cfg.dtype))),
                dict(token=ctx.spec(("batch", "seq", "act_embed"))))
    return (dict(token=BatchSpec((B, 1), torch.int32)),
            dict(token=ctx.spec(("batch", "seq"))))


def _make_ctx_for(cfg, mesh, shape, fsdp_mode: str = "always",
                  seq_parallel: bool = False):
    sizes = mesh_shape(mesh)
    dp_size = sizes.get("data", 1) * sizes.get("pod", 1)
    fsdp = pick_optimizer(cfg)[2]
    if fsdp_mode == "train-only" and shape.kind != "train":
        # serving keeps weights model-sharded: FSDP's per-step weight
        # re-gather is pure loss without optimizer state
        fsdp = False
    ctx = make_ctx(cfg, mesh, fsdp=fsdp, dp_over_pod=True,
                   seq_parallel=seq_parallel)
    if shape.global_batch < dp_size:
        rules = dict(ctx.rules)
        rules["batch"] = None        # B=1 long-decode: replicate batch
        ctx = dataclasses.replace(ctx, rules=rules)
    return ctx


def parse_overrides(pairs):
    """--set key=value pairs -> typed ModelConfig overrides."""
    from repro_torch.configs.base import ModelConfig
    types = {f.name: f.type for f in dataclasses.fields(ModelConfig)}
    out = {}
    for pair in pairs or []:
        k, v = pair.split("=", 1)
        t = str(types.get(k, "str"))
        if "bool" in t:
            out[k] = v.lower() in ("1", "true", "yes")
        elif "int" in t:
            out[k] = int(v)
        elif "float" in t:
            out[k] = float(v)
        else:
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------


def fake_device() -> str:
    """``cuda`` where PyTorch is built with CUDA, else ``meta``: a build
    without CUDA cannot record autograd on fake CUDA tensors."""
    return "cuda" if torch.backends.cuda.is_built() else "meta"


def join_fake_mesh(multi_pod: bool = False):
    """The production mesh (``production_shape``) as a ``DeviceMesh`` over
    a ``"fake"`` default group of its size, this process its rank 0; a
    default group already there is destroyed first."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape, axes = production_shape(multi_pod)
    if dist.is_initialized():
        dist.destroy_process_group()
    n = 1
    for s in shape:
        n *= s
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _zeros(spec, ctx, axes, device):
    shape = ctx.local_shape(spec.shape, axes)
    return torch.zeros(shape, dtype=spec.dtype, device=device)


def _build(cfg, shape, ctx, device):
    """The cell's model, its step and the step's arguments, on fake
    tensors: (model, run, state (optimizer state or cache), inputs)."""
    from repro_torch.models import transformer as tfm
    from repro_torch.train.trainer import BATCH_AXES

    model = tfm.Transformer(cfg, device, ctx=ctx)
    # trainable for serving too: MemTracker hooks every parameter's
    # gradient (a serving step runs under inference mode all the same)
    params = trainable_params(model)
    specs, _ = input_specs(cfg, shape, ctx)
    if shape.kind == "train":
        opt = pick_optimizer(cfg)[0](model)
        state = opt.init(params)
        batch = {k: _zeros(v, ctx, BATCH_AXES[k], device)
                 for k, v in specs.items()}
        step = make_train_step(cfg, ctx, opt)
        return model, lambda: step(model, state, batch), state, batch
    cache = tfm.init_cache(cfg, shape.global_batch, shape.seq_len,
                           dtype=cfg.dtype, device=device, ctx=ctx)
    if shape.kind == "prefill":
        axes = dict(tokens=("batch", None),
                    embeds=("batch", None, "act_embed"))
        batch = {k: _zeros(v, ctx, axes[k], device)
                 for k, v in specs.items()}
        step = make_prefill_step(cfg, ctx)
        return model, lambda: step(model, batch, cache), cache, batch
    axes = ("batch", None, "act_embed") if frontends.uses_embeds(cfg) else (
        "batch", None)
    token = _zeros(specs["token"], ctx, axes, device)
    step = make_decode_step(cfg, ctx)
    t = shape.seq_len - 1
    return model, lambda: step(model, token, cache, t), cache, dict(
        token=token)


def flop_count():
    """A dispatch mode that adds up, by operator, the FLOPs of every
    operator with a formula in ``torch.utils.flop_counter``'s registry
    (``FlopCounterMode``'s formulas, the kernels' operators' among them),
    without ``FlopCounterMode``'s module tracking, whose hooks keep
    tensors alive past their use and would raise ``MemTracker``'s peak."""
    import collections

    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class FlopCount(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.by_op = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            formula = flop_registry.get(func._overloadpacket)
            if formula is None and func is not torch.ops.prim.device.default:
                # an operator with no formula is counted by its parts
                # where it has some (matmul under inference mode), as
                # FlopCounterMode counts it
                with self:
                    out = func.decompose(*args, **kwargs)
                if out is not NotImplemented:
                    return out
            out = func(*args, **kwargs)
            if formula is not None:
                self.by_op[str(func._overloadpacket)] += formula(
                    *args, **kwargs, out_val=out)
            return out

    return FlopCount()


def trace_cell(cfg, shape, ctx) -> dict:
    """Build the cell under ``FakeTensorMode`` and run its step once,
    under ``MemTracker`` and ``flop_count``: the rank's peak, its FLOPs
    (by operator too) and its collectives' result bytes by the
    reference's kind names."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.distributed import collectives

    with FakeTensorMode(allow_non_fake_inputs=True):
        model, run, state, inputs = _build(cfg, shape, ctx, fake_device())
        mem = MemTracker()
        mem.track_external(model, *_leaves(state), *_leaves(inputs))
        collectives.reset_counts()
        with mem, flop_count() as flops:
            run()
        peak = max(v["Total"] for v in mem.get_tracker_snapshot(
            "peak").values())
    coll = {}
    for kind, c in collectives.counts().items():
        name = KIND_NAMES.get(kind)
        if name:
            coll[name] = coll.get(name, 0) + c["result_bytes"]
    if coll:
        coll["total"] = sum(coll.values())
    return dict(flops=float(sum(flops.by_op.values())), collectives=coll,
                peak=int(peak), by_op=dict(flops.by_op))


def ce_recompute_flops(cfg, shape, ctx) -> int:
    """The FLOPs of the rank's cross-entropy backward recomputing each
    chunk's logits (``train/losses.py`` never holds them; the reference
    keeps them): 2 T D V, T the rank's tokens, V its vocab columns."""
    from repro_torch.models.common import padded_vocab
    from repro_torch.train.trainer import BATCH_AXES

    if shape.kind != "train":
        return 0
    B = ctx.local_shape((shape.global_batch, 1), BATCH_AXES["tokens"])[0]
    V = padded_vocab(cfg)
    if ctx.sharded("vocab"):
        V //= ctx.size("model")
    return 2 * B * shape.seq_len * cfg.d_model * V


def measure_analysis(cfg, shape, mesh, fsdp_mode: str = "always",
                     seq_parallel: bool = False) -> dict:
    """Per-rank FLOPs, collective bytes and peak, traced at L1 and L2 (1
    and 2 cycles of the layer pattern, after the leading dense layers)
    and extrapolated linearly in depth, as the reference does. ``flops``
    leaves out the cross-entropy's recompute (``ce_recompute_flops``),
    which the reference's step does not do; ``traced_flops`` has it."""
    p = len(cfg.block_pattern)
    fk = cfg.first_k_dense
    L1, L2 = fk + p, fk + 2 * p
    runs = {}
    t0 = time.perf_counter()
    # a model of depth L1 or L2 is traced at its own depth alone
    for L in ((cfg.n_layers,) if cfg.n_layers in (L1, L2) else (L1, L2)):
        c = dataclasses.replace(cfg, n_layers=L)
        runs[L] = trace_cell(c, shape, _make_ctx_for(
            c, mesh, shape, fsdp_mode, seq_parallel))
    trace_s = time.perf_counter() - t0
    n_extra = cfg.n_layers - L1

    def extra(a, b):
        return a + (b - a) / p * n_extra

    r1 = runs.get(L1) or runs[L2]        # one run: its own numbers
    r2 = runs.get(L2, r1)
    coll = {k: extra(r1["collectives"].get(k, 0), r2["collectives"].get(k, 0))
            for k in set(r1["collectives"]) | set(r2["collectives"])}
    traced = extra(r1["flops"], r2["flops"])
    recompute = ce_recompute_flops(cfg, shape, _make_ctx_for(
        cfg, mesh, shape, fsdp_mode, seq_parallel))
    notes = ["flops: matrix products and the kernels' FLOP formulas "
             "(FlopCounterMode's registry), attention as dense S^2; elementwise work "
             "is not counted, which XLA counts; the cross-entropy "
             "backward's logits recompute (ce_recompute_flops) is left "
             "out, as the reference does not do it (traced_flops has it)",
             "flops, collectives and peak depth-extrapolated from traced "
             "L=%s" % ",".join(map(str, sorted(runs)))]
    if "rwkv" in cfg.block_pattern:
        notes.append("rwkv wkv scan: the rwkv6_scan operator's formula, "
                     "8 B S H hd^2 forward and twice that backward, what "
                     "the reference's correction counts")
    return dict(flops=traced - recompute, traced_flops=traced,
                ce_recompute_flops=recompute, collectives=coll,
                peak_bytes=extra(r1["peak"], r2["peak"]), trace_s=trace_s,
                by_op={k: extra(r1["by_op"].get(k, 0), r2["by_op"].get(k, 0))
                       for k in set(r1["by_op"]) | set(r2["by_op"])},
                notes=notes)


# ---------------------------------------------------------------------------
# a cell
# ---------------------------------------------------------------------------


def argument_bytes(cfg, shape, ctx) -> dict:
    """The rank's argument bytes at full depth, built on fake tensors
    (nothing traced): parameters, optimizer state (training) and inputs
    or cache."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        model, _, state, inputs = _build(cfg, shape, ctx, fake_device())
        params = _nbytes(model.parameters())
        held = _nbytes(_leaves(state))
        given = _nbytes(_leaves(inputs))
    if shape.kind == "train":
        return dict(parameters=params, optimizer=held, inputs=given)
    return dict(parameters=params, optimizer=0, inputs=given + held)


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             skip_hlo_bytes: bool = False, overrides: dict = None,
             fsdp_mode: str = "always", seq_parallel: bool = False) -> dict:
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return dict(arch=arch, shape=shape_name, mesh=mesh_kind,
                    status="skipped", reason=why)

    mesh = join_fake_mesh(multi_pod=(mesh_kind == "multipod"))
    n_chips = mesh.size()
    ctx = _make_ctx_for(cfg, mesh, shape, fsdp_mode, seq_parallel)
    split = argument_bytes(cfg, shape, ctx)
    analysis = None
    if not skip_hlo_bytes:
        analysis = measure_analysis(cfg, shape, mesh, fsdp_mode,
                                    seq_parallel)
    args = sum(split.values())
    peak = None if analysis is None else int(analysis["peak_bytes"])
    if peak is not None:
        split["activations"] = peak - args
    return dict(
        arch=arch, shape=shape_name, mesh=mesh_kind, status="ok",
        n_chips=int(n_chips), device=fake_device(),
        lower_s=None, compile_s=None,
        trace_s=None if analysis is None else round(analysis["trace_s"], 1),
        hlo_gflops=None if analysis is None else analysis["flops"] / 1e9,
        hlo_bytes_accessed=None,
        collective_bytes={} if analysis is None else analysis["collectives"],
        analysis=analysis,
        memory=dict(argument_bytes=args, output_bytes=None,
                    temp_bytes=None if peak is None else peak - args,
                    peak_bytes=peak, split=split),
        params_total=cfg.param_counts()["total"],
        params_active=cfg.param_counts()["active"],
        notes=["traced on fake tensors over a fake process group of "
               f"{n_chips} ranks, this process rank 0: nothing allocated, "
               "nothing launched; no card needed",
               "hlo_bytes_accessed, lower_s, compile_s: XLA's, no "
               "counterpart here (trace_s: the traces' wall time)",
               "output_bytes: the step writes its state in place",
               "hlo_gflops = analysis.flops / 1e9: the port counts every "
               "layer, no scan body once"],
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--skip-hlo-bytes", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="ModelConfig override key=value (repeatable)")
    ap.add_argument("--tag", default="",
                    help="artifact-name suffix for variants")
    ap.add_argument("--fsdp-mode", default="always",
                    choices=["always", "train-only"])
    ap.add_argument("--seq-parallel", action="store_true",
                    help="sequence-parallel residual stream (SP variant)")
    ap.add_argument("--refresh-analysis", action="store_true",
                    help="recompute only the `analysis` block of an "
                         "existing ok artifact")
    args = ap.parse_args(argv)
    overrides = parse_overrides(args.set)

    os.makedirs(args.out, exist_ok=True)
    cells = []
    if args.all:
        for arch in list_configs():
            for shape in SHAPES:
                for mesh in ("pod", "multipod"):
                    cells.append((arch, shape, mesh))
    else:
        cells = [(args.arch, args.shape, args.mesh)]

    failures = 0
    for arch, shape, mesh in cells:
        tag = f"{arch}__{shape}__{mesh}"
        if args.tag:
            tag += f"__{args.tag}"
        path = os.path.join(args.out, tag + ".json")
        try:
            if args.refresh_analysis and os.path.exists(path):
                with open(path) as f:
                    res = json.load(f)
                if res.get("status") == "ok":
                    v = res.get("variant") or {}
                    cfg = get_config(arch)
                    ov = v.get("overrides") or overrides
                    if ov:
                        cfg = dataclasses.replace(cfg, **ov)
                    m = join_fake_mesh(multi_pod=(mesh == "multipod"))
                    res["analysis"] = measure_analysis(
                        cfg, SHAPES[shape], m,
                        v.get("fsdp_mode", args.fsdp_mode),
                        v.get("seq_parallel", False))
            else:
                res = run_cell(arch, shape, mesh, args.skip_hlo_bytes,
                               overrides=overrides, fsdp_mode=args.fsdp_mode,
                               seq_parallel=args.seq_parallel)
                res["variant"] = dict(tag=args.tag, overrides=overrides,
                                      fsdp_mode=args.fsdp_mode,
                                      seq_parallel=args.seq_parallel)
        except Exception as e:  # noqa: BLE001 — record the failure honestly
            res = dict(arch=arch, shape=shape, mesh=mesh, status="error",
                       error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-4000:])
            failures += 1
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        status = res["status"]
        extra = ""
        if status == "ok" and res.get("analysis"):
            mem = res["memory"]
            extra = (f" gflops={res['hlo_gflops']:.1f}"
                     f" argument_bytes={mem['argument_bytes']}"
                     f" peak_bytes={mem['peak_bytes']}"
                     f" trace={res['trace_s']}s")
        print(f"[dryrun] {tag}: {status}{extra}", flush=True)
        if status == "error":
            print(res["error"], flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
