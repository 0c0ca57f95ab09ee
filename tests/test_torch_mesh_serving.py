"""Tensor-parallel serving of the port's LMs over a ``("data", "model")``
mesh on the CPU: ranks are processes joined over gloo on 127.0.0.1,
each reporting to a file under ``tmp_path``.

Meshes (data 1, model 2) and (2, 2) over reduced float32 configs of the
four LM families (Qwen2, RecurrentGemma, RWKV6, Qwen1.5-MoE in both
``moe_sharding`` modes, and with float8 experts), a one-KV-head dense
config whose cache splits its sequence over ``model`` (the ``kv_seq``
decode), a 6/3-head one whose ranks' query heads straddle KV groups, and
a RecurrentGemma whose single gate block spans both ranks' channels;
(1, 4) over a
6-query / 2-KV-head config in ``attn_sharding="padded"`` mode
(``_pad_group``). Each rank builds the unsharded model and its own
shards from the same seeded draws and holds the mesh run to the
``ctx=None`` run: the prefill's and 4 decode steps' logits within
``TOL`` (float32 sums over ranks in another order), the greedy tokens
equal, and the ranks' cache shards, put together, the ``ctx=None``
cache within ``TOL`` (slot positions exactly). A prefill of 14 tokens
rolls a 12-slot ring and the decode steps wrap it; ``greedy_generate``
runs a 32-slot ring.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.distributed import sharding as sh
from repro_torch.models import transformer as tfm

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5            # float32: partial sums over ranks in another order
B, S, N_DECODE, MAX_SEQ, GEN_MAX_SEQ, N_NEW = 4, 14, 4, 12, 32, 5
SPAWN_TIMEOUT = 240


def _configs(case):
    qwen = reduced(get_config("qwen2-1.5b"))
    moe = reduced(get_config("qwen2-moe-a2.7b"))
    if case == "padded":
        return {"padded 6/2": dataclasses.replace(
            qwen, n_heads=6, n_kv_heads=2, attn_sharding="padded")}
    return {
        "qwen2": qwen,
        "recurrentgemma": reduced(get_config("recurrentgemma-2b")),
        "rwkv6": reduced(get_config("rwkv6-3b")),
        "moe tensor": dataclasses.replace(moe, moe_sharding="tensor"),
        "moe expert": dataclasses.replace(moe, moe_sharding="expert"),
        "dense 1 kv head": dataclasses.replace(qwen, n_kv_heads=1,
                                               attn_sharding="heads"),
        # 6 query heads over 3 KV heads at model 2: a rank's 3 query
        # heads span two KV groups unevenly (a KV head per query head)
        "dense 3 kv heads": dataclasses.replace(qwen, n_heads=6,
                                                n_kv_heads=3),
        # one gate block: the channels split over model, the block not
        "recurrentgemma 1 gate block": dataclasses.replace(
            reduced(get_config("recurrentgemma-2b")), lru_gate_blocks=1),
        # float8 experts: the scale of each whole expert, a max over model
        "moe tensor float8": dataclasses.replace(
            moe, moe_sharding="tensor", moe_weight_dtype="float8_e4m3fn"),
    }


CASES = {"tp2": ((1, 2), "lm"), "dp2tp2": ((2, 2), "lm"),
         "padded": ((1, 4), "padded")}


# ---------------------------------------------------------------------------
# a rank
# ---------------------------------------------------------------------------


def _logits_run(model, cfg, tokens, cache, ctx=None):
    """Prefill logits of the last position, then N_DECODE greedy decode
    steps' logits (B_local, N_DECODE + 1, Vp)."""
    Bl = tokens.shape[0]
    out = []
    with torch.inference_mode():
        pos = torch.arange(S, dtype=torch.int32).expand(Bl, S)
        h, cache, _ = tfm.forward(model, tokens=tokens, positions=pos,
                                  cache=cache, t=0, mode="prefill")
        out.append(tfm.logits_fn(model, h[:, -1:]))
        for t in range(S, S + N_DECODE):
            tok = torch.argmax(out[-1], dim=-1).to(torch.int32)
            pos = torch.full((Bl, 1), t, dtype=torch.int32)
            h, cache, _ = tfm.forward(model, tokens=tok, positions=pos,
                                      cache=cache, t=t, mode="decode")
            out.append(tfm.logits_fn(model, h))
    return torch.cat(out, dim=1), cache


def _rank(rank, world, port, case, out):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.collectives import counts
    from repro_torch.runtime import serve as rserve

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    shape, which = CASES[case]
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    prompt = torch.as_tensor(np.random.default_rng(3).integers(
        0, 500, (B, S)), dtype=torch.int32)
    report = {}
    for name, cfg in _configs(which).items():
        ctx = sh.make_ctx(cfg, mesh)
        full = tfm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
        part = tfm.init_model(cfg, torch.Generator().manual_seed(0), "cpu",
                              ctx=ctx)
        want, cache_w = _logits_run(
            full, cfg, prompt, tfm.init_cache(cfg, B, MAX_SEQ, cfg.dtype,
                                              "cpu"))
        got, cache_g = _logits_run(
            part, cfg, ctx.local(prompt, ("batch", None)),
            tfm.init_cache(cfg, B, MAX_SEQ, cfg.dtype, "cpu", ctx=ctx), ctx)
        want = ctx.local(want, ("batch", None, None))
        gen_w = rserve.greedy_generate(full, cfg, prompt, N_NEW, GEN_MAX_SEQ)
        gen_g = rserve.greedy_generate(part, cfg, prompt, N_NEW, GEN_MAX_SEQ,
                                       ctx)
        report[name] = dict(
            logits_err=float((got - want).abs().max()),
            logits_scale=float(want.abs().max()),
            argmax_equal=bool(torch.equal(got.argmax(-1), want.argmax(-1))),
            tokens_equal=bool(torch.equal(gen_g, gen_w)),
            tokens_shape=list(gen_g.shape),
            coordinate=list(mesh.get_coordinate()),
            cache=[{k: v.clone() for k, v in layer.items()}
                   for layer in cache_g],
            cache_want=([{k: v.clone() for k, v in layer.items()}
                         for layer in cache_w] if rank == 0 else None))
    # bfloat16 through the helper: a gather along each dim, and a sum
    ctx = sh.make_ctx(cfg, mesh)
    whole = torch.arange(4 * 8 * shape[1], dtype=torch.bfloat16).reshape(
        4, 8 * shape[1]) / 7
    from repro_torch.distributed.collectives import mesh_collective
    report["bf16"] = dict(
        gather_last=bool(torch.equal(mesh_collective(
            "gather", ctx.local(whole, (None, "vocab")), ctx, dim=-1),
            whole)),
        gather_first=bool(torch.equal(mesh_collective(
            "gather", ctx.local(whole.t().contiguous(), ("vocab", None)),
            ctx, dim=0), whole.t())),
        sum=bool(torch.equal(mesh_collective(
            "sum", torch.ones(3, dtype=torch.bfloat16), ctx),
            torch.full((3,), float(shape[1]), dtype=torch.bfloat16))))
    report["collectives"] = counts()
    torch.save(report, out)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(case, tmp_path):
    """Run ``case`` on its mesh's ranks, a process each; their reports."""
    world = int(np.prod(CASES[case][0]))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    outs = [tmp_path / f"{case}.{r}.pt" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r), str(world), str(port),
         case, str(outs[r])], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
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
def reports(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_serving")
    return {case: spawn(case, tmp) for case in CASES}


def _assemble(reports, name, cfg, mesh_shape):
    """The ranks' cache shards put back into whole tensors, one per
    layer and key, each at the offsets its rank's spec gives."""
    out = []
    kinds = cfg.layer_kinds()
    for li, kind in enumerate(kinds):
        layer = {}
        for key, t in tfm.block_cache_template(cfg, kind, B,
                                               MAX_SEQ).items():
            whole = None
            for rep in reports:
                piece = rep[name]["cache"][li][key]
                mesh = sh.AbstractMesh(mesh_shape, ("data", "model"),
                                       tuple(rep[name]["coordinate"]))
                ctx = sh.make_ctx(cfg, mesh)
                if whole is None:
                    whole = torch.full(t.shape, float("nan"),
                                       dtype=torch.float64)
                ctx.local(whole, t.axes).copy_(piece.double())
            layer[key] = whole
        out.append(layer)
    return out


LM_NAMES = list(_configs("lm"))
PARAMS = [(case, name) for case in ("tp2", "dp2tp2") for name in LM_NAMES] \
    + [("padded", "padded 6/2")]


@pytest.mark.parametrize("case,name", PARAMS)
def test_tensor_parallel_logits_and_tokens_equal_unsharded(reports, case,
                                                           name):
    for rep in reports[case]:
        r = rep[name]
        assert r["logits_err"] <= TOL * max(1.0, r["logits_scale"]), r[
            "logits_err"]
        assert r["argmax_equal"]
        assert r["tokens_equal"]
        assert r["tokens_shape"] == [B, N_NEW]


@pytest.mark.parametrize("case,name", PARAMS)
def test_cache_shards_put_together_are_the_unsharded_cache(reports, case,
                                                           name):
    which = CASES[case][1]
    cfg = _configs(which)[name]
    got = _assemble(reports[case], name, cfg, CASES[case][0])
    want = reports[case][0][name]["cache_want"]
    for g, w in zip(got, want):
        for key in w:
            assert not torch.isnan(g[key]).any(), key
            if key == "pos":
                assert torch.equal(g[key].long(), w[key].long())
            else:
                np.testing.assert_allclose(g[key].numpy(),
                                           w[key].double().numpy(),
                                           atol=TOL, rtol=TOL)


def test_collectives_were_counted(reports):
    """Every model-axis collective went through the one helper: sums and
    gathers were counted on each rank, no bytes staged on the CPU."""
    for case, reps in reports.items():
        for rep in reps:
            c = rep["collectives"]
            assert c["sum"]["calls"] > 0 and c["gather"]["calls"] > 0, case
            assert all(v["staged_bytes"] == 0 for v in c.values())


def test_bfloat16_collectives_over_gloo(reports):
    """gloo gathers no 16-bit integers: a bfloat16 gather travels as its
    bytes, along the last dim or another, and comes back bit for bit."""
    for reps in reports.values():
        for rep in reps:
            assert rep["bf16"] == dict(gather_last=True, gather_first=True,
                                       sum=True)


def test_kv_seq_paths_taken():
    """The dense one-KV-head config at model 2 splits its cache's
    sequence and its query heads; the padded config at model 4 pads 3
    query heads a group to 4; RecurrentGemma's local attention keeps its
    heads whole and splits its ring."""
    mesh = sh.AbstractMesh((1, 2), ("data", "model"), (0, 1))
    cfgs = _configs("lm")
    hs = tfm.HeadShard(cfgs["dense 1 kv head"],
                       sh.make_ctx(cfgs["dense 1 kv head"], mesh))
    assert hs.kv_seq and hs.act and not hs.kv_local and hs.n == 2
    uneven = tfm.HeadShard(cfgs["dense 3 kv heads"],
                           sh.make_ctx(cfgs["dense 3 kv heads"], mesh))
    assert uneven.kv_idx.tolist() == [1, 2, 2]          # heads 3, 4, 5
    rg = tfm.HeadShard(cfgs["recurrentgemma"],
                       sh.make_ctx(cfgs["recurrentgemma"], mesh))
    assert rg.kv_seq and not rg.act
    cfg = _configs("padded")["padded 6/2"]
    mesh4 = sh.AbstractMesh((1, 4), ("data", "model"), (0, 1))
    pd = tfm.HeadShard(cfg, sh.make_ctx(cfg, mesh4))
    assert (pd.pad_g, pd.Gp, pd.n, pd.j0) == (1, 4, 2, 2)
    assert pd.kv_idx == slice(0, 1)
    q = torch.arange(6.0).reshape(1, 1, 6, 1)
    assert pd.queries(q).flatten().tolist() == [2.0, 0.0]


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        r, w, port, case, out = sys.argv[2:7]
        _rank(int(r), int(w), int(port), case, out)
