"""The port's serving path for the MoE archs, Qwen1.5-MoE-A2.7B and Kimi
K2 (its dense first layer included), against the reference on the CPU
in reduced form, with the reference's initialized parameters carried
across: split serving equals the full forward and the reference's
runner, prefill + one decode step equals the full forward and the
reference's decode step (every layer's KV cache, written in place, equal
to the reference's), greedy decoding gives the reference's tokens
exactly, and the serving entry point picks the reference's split and
power.

Tolerances: logits, hidden states and caches atol 1e-4, rtol 1e-3
(float32, the reference's own bar in ``tests/test_integration.py``);
tokens, split, power and evaluation counts exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.launch import serve as ref_launch
from repro.models import transformer as ref_tfm
from repro.runtime import serve as ref_serve
from repro.runtime.splitpoint import SplitRunner as RefSplitRunner
from repro_torch.configs import get_config, reduced
from repro_torch.interop import model_from_reference
from repro_torch.launch import serve as port_launch
from repro_torch.models import transformer as port_tfm
from repro_torch.runtime import serve as port_serve
from repro_torch.runtime.splitpoint import SplitRunner

torch.set_num_threads(1)
ATOL, RTOL = 1e-4, 1e-3
B = 2
MOE_ARCHS = ["qwen2-moe-a2.7b", "kimi-k2-1t-a32b"]


@pytest.fixture(scope="module")
def models(request):
    """(reference cfg, params, port cfg, port model), built once an arch."""
    cfg = ref_reduced(ref_get_config(request.param))
    params = ref_tfm.init_model(jax.random.PRNGKey(0), cfg)
    pcfg = reduced(get_config(request.param))
    model = model_from_reference(pcfg, jax.tree.map(np.asarray, params),
                                 "cpu")
    return cfg, params, pcfg, model


def tokens(cfg, seq, seed=1):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, cfg.vocab_size, (B, seq)).astype(np.int32)
    return jnp.asarray(t), torch.as_tensor(t)


def positions(seq):
    p = np.broadcast_to(np.arange(seq, dtype=np.int32), (B, seq)).copy()
    return jnp.asarray(p), torch.as_tensor(p)


BOTH = pytest.mark.parametrize("models", MOE_ARCHS, indirect=True)
# one compile of the reference's forward a mode, in place of the eager
# op-by-op compiles (8x the time for Kimi K2's unscanned groups)
REF_FORWARD = jax.jit(ref_tfm.forward, static_argnames=("cfg", "ctx",
                                                        "mode"))


@BOTH
def test_moe_split_runner_matches_full_forward_and_reference(models):
    cfg, params, pcfg, model = models
    jt, tt = tokens(cfg, 16)
    jp, tp = positions(16)
    hidden, _, _ = port_tfm.forward(model, tokens=tt, positions=tp,
                                    mode="train")
    full = port_tfm.logits_fn(model, hidden)
    ref_runner = RefSplitRunner(cfg, params, B, 16)
    runner = SplitRunner(pcfg, model, B, 16)
    for l in [0, 1, cfg.n_layers]:
        logits, bb = runner.run(l, tokens=tt)
        want, ref_bb = ref_runner.run(l, tokens=jt)
        assert torch.equal(logits, full), l      # same ops on the same data
        np.testing.assert_allclose(logits.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=RTOL)
        assert bb == ref_bb == B * 16 * cfg.d_model * 4  # f32 boundary


@BOTH
def test_moe_run_layers_sums_the_aux_losses(models):
    """``run_layers`` over [0, l) and [l, L) adds up to the forward's
    aux, as the reference's ``run_layers`` does."""
    from repro_torch.runtime.splitpoint import run_layers
    cfg, params, pcfg, model = models
    _, tt = tokens(cfg, 16)
    _, tp = positions(16)
    _, _, aux = port_tfm.forward(model, tokens=tt, positions=tp)
    x = port_tfm.embed_lookup(model, tt).float()
    x, lo = run_layers(model, x, tp, 0, 1)
    _, hi = run_layers(model, x, tp, 1, cfg.n_layers)
    assert float(hi) > 0 and (float(lo) == 0) == (cfg.first_k_dense > 0)
    np.testing.assert_allclose(float(lo + hi), float(aux), atol=1e-6,
                               rtol=1e-6)


@BOTH
def test_moe_prefill_then_decode(models):
    """Prefill 23 tokens, decode the 24th: equal to the full forward and
    to the reference's decode step, with every layer's KV cache written
    in place and equal to the reference's."""
    cfg, params, pcfg, model = models
    S = 24
    jt, tt = tokens(cfg, S, seed=2)
    jp, tp = positions(S)
    full, _, _ = port_tfm.forward(model, tokens=tt, positions=tp,
                                  mode="train")
    cache = port_tfm.init_cache(pcfg, B, S, dtype=torch.float32,
                                device="cpu")
    held = [dict(entry) for entry in cache]
    port_tfm.forward(model, tokens=tt[:, :S - 1], positions=tp[:, :S - 1],
                     cache=cache, t=0, mode="prefill")
    dec, out_cache, _ = port_tfm.forward(
        model, tokens=tt[:, S - 1:], positions=tp[:, S - 1:], cache=cache,
        t=S - 1, mode="decode")
    rc = ref_tfm.init_cache(cfg, B, S, dtype=jnp.float32)
    _, rc, _ = REF_FORWARD(params, cfg=cfg, ctx=None, tokens=jt[:, :S - 1],
                           positions=jp[:, :S - 1], cache=rc,
                           t=jnp.array(0), mode="prefill")
    rdec, rc, _ = REF_FORWARD(params, cfg=cfg, ctx=None,
                              tokens=jt[:, S - 1:], positions=jp[:, S - 1:],
                              cache=rc, t=jnp.array(S - 1), mode="decode")
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, S - 1].numpy(),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(dec[:, 0].numpy(), np.asarray(rdec[:, 0]),
                               atol=ATOL, rtol=RTOL)
    assert out_cache is cache
    for li, entry in enumerate(cache):
        gi, _, _, idx = next(g for g in port_tfm.group_layers(pcfg)
                             if any(li in row for row in g[3]))
        r = next(r for r, row in enumerate(idx) if li in row)
        want = rc["groups"][f"g{gi}"]["b0"]
        for name, t in entry.items():
            assert t is held[li][name], (li, name)      # in place
            w = np.asarray(want[name])
            np.testing.assert_allclose(t.numpy(), w[r] if len(idx) > 1
                                       else w, atol=ATOL, rtol=RTOL,
                                       err_msg=f"{li} {name}")


# Qwen2-MoE only: the reference's eager decode loop compiles op by op,
# 12 s for Kimi K2, whose steps the prefill + decode case above holds
@pytest.mark.parametrize("models", MOE_ARCHS[:1], indirect=True)
def test_moe_greedy_generate_gives_the_reference_tokens(models):
    cfg, params, pcfg, model = models
    jt, tt = tokens(cfg, 20, seed=4)
    want = ref_serve.greedy_generate(params, cfg, None, jt, 6, 32)
    got = port_serve.greedy_generate(model, pcfg, tt, 6, 32)
    assert got.dtype == torch.int32 and got.shape == (B, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch, line", [
    ("qwen2-moe-a2.7b", "split l=1/24 P=0.059 W"),
    ("kimi-k2-1t-a32b", "split l=1/61 P=0.016 W"),
])
def test_moe_serve_entry_point_picks_the_reference_split(arch, line,
                                                         capsys):
    argv = ["--arch", arch, "--reduced"]
    want = ref_launch.main(argv)
    got = port_launch.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    pb = port_launch.build_problem(get_config(arch), 32)
    rpb = ref_launch.build_problem(ref_get_config(arch), 32)
    l, p = pb.denormalize(got.best_a)
    rl, rp = rpb.denormalize(want.best_a)
    assert (l, round(p, 3), got.n_evals) == (rl, round(rp, 3), want.n_evals)
    assert out.count(line) == 2 and out.count("(15 evals") == 2
    assert out.count("feasible=True") == 2
