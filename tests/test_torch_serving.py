"""The port's serving path (``runtime.splitpoint``, ``runtime.serve``,
``launch.serve``) against the reference on the CPU, with the reference's
initialized parameters carried across: split serving equals the full
forward and the reference's runner, prefill + one decode step equals the
full forward (the KV cache, its ring roll and the windowed ring decode
included), greedy decoding gives the reference's tokens exactly, and the
serving entry point picks the reference's split and power.

Tolerances: logits and hidden states atol 1e-4, rtol 1e-3 (float32, the
reference's own bar in ``tests/test_integration.py``); decode against
the full forward atol 1e-4 (the reference's own test allows 2e-2; the
port's cache is float32 here); tokens, split, power and evaluation
counts exactly."""
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
from repro_torch.models import frontends
from repro_torch.models import transformer as port_tfm
from repro_torch.runtime import serve as port_serve
from repro_torch.runtime.splitpoint import SplitRunner

torch.set_num_threads(1)
ATOL, RTOL = 1e-4, 1e-3
B = 2


def models(arch):
    cfg = ref_reduced(ref_get_config(arch))
    params = ref_tfm.init_model(jax.random.PRNGKey(0), cfg)
    pcfg = reduced(get_config(arch))
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


def test_split_runner_matches_full_forward_and_reference():
    cfg, params, pcfg, model = models("deepseek-7b")
    jt, tt = tokens(cfg, 16)
    jp, tp = positions(16)
    hidden, _, _ = port_tfm.forward(model, tokens=tt, positions=tp,
                                    mode="train")
    full = port_tfm.logits_fn(model, hidden)
    ref_runner = RefSplitRunner(cfg, params, B, 16)
    runner = SplitRunner(pcfg, model, B, 16)
    for l in [0, 1, cfg.n_layers // 2, cfg.n_layers]:
        logits, bb = runner.run(l, tokens=tt)
        want, ref_bb = ref_runner.run(l, tokens=jt)
        assert torch.equal(logits, full), l      # same ops on the same data
        np.testing.assert_allclose(logits.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=RTOL)
        assert bb == ref_bb == B * 16 * cfg.d_model * 4  # f32 boundary


def _prefill_decode(arch, S):
    """Port: full forward vs prefill(S-1) + decode(token S-1); reference:
    the same decode step. Returns the three last-position states."""
    cfg, params, pcfg, model = models(arch)
    rng = np.random.default_rng(2)
    if frontends.uses_embeds(cfg):
        x = (rng.standard_normal((B, S, cfg.d_model)) * 0.02
             ).astype(np.float32)
        key = "embeds"
    else:
        x = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        key = "tokens"
    jp, tp = positions(S)
    full, _, _ = port_tfm.forward(model, positions=tp, mode="train",
                                  **{key: torch.as_tensor(x)})

    cache = port_tfm.init_cache(pcfg, B, S, dtype=torch.float32,
                                device="cpu")
    _, cache, _ = port_tfm.forward(model, positions=tp[:, :S - 1],
                                   cache=cache, t=0, mode="prefill",
                                   **{key: torch.as_tensor(x[:, :S - 1])})
    dec, cache, _ = port_tfm.forward(model, positions=tp[:, S - 1:],
                                     cache=cache, t=S - 1, mode="decode",
                                     **{key: torch.as_tensor(x[:, S - 1:])})

    rc = ref_tfm.init_cache(cfg, B, S, dtype=jnp.float32)
    _, rc, _ = ref_tfm.forward(params, cfg, None, positions=jp[:, :S - 1],
                               cache=rc, t=jnp.array(0), mode="prefill",
                               **{key: jnp.asarray(x[:, :S - 1])})
    rdec, _, _ = ref_tfm.forward(params, cfg, None, positions=jp[:, S - 1:],
                                 cache=rc, t=jnp.array(S - 1), mode="decode",
                                 **{key: jnp.asarray(x[:, S - 1:])})
    return full[:, S - 1], dec[:, 0], np.asarray(rdec[:, 0]), cache


@pytest.mark.parametrize("arch, S", [
    ("qwen2-1.5b", 32),
    ("h2o-danube-3-4b", 64),     # window 16: the S >= C roll + ring decode
    ("musicgen-large", 32),      # embeds input
], ids=["qwen2", "h2o_window_ring", "musicgen_embeds"])
def test_prefill_then_decode_matches_full_forward(arch, S):
    full, dec, ref_dec, cache = _prefill_decode(arch, S)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(dec.numpy(), ref_dec, atol=ATOL, rtol=RTOL)
    if arch == "h2o-danube-3-4b":             # ring of 16 slots, wrapped
        pos = cache[0]["pos"]
        assert pos.shape == (B, 16)
        assert torch.equal(pos[0].long() % 16, torch.arange(16))
        assert int(pos.max()) == S - 1 and int(pos.min()) == S - 16


def test_prefill_cache_matches_reference_layout():
    """The in-place prefill write leaves the reference's cache contents,
    short (S < C) and rolled (S >= C)."""
    for arch, S, max_seq in (("qwen2-1.5b", 10, 24),
                             ("h2o-danube-3-4b", 37, 64)):
        cfg, params, pcfg, model = models(arch)
        jt, tt = tokens(cfg, S)
        jp, tp = positions(S)
        cache = port_tfm.init_cache(pcfg, B, max_seq, dtype=torch.float32,
                                    device="cpu")
        port_tfm.forward(model, tokens=tt, positions=tp, cache=cache, t=0,
                         mode="prefill")
        rc = ref_tfm.init_cache(cfg, B, max_seq, dtype=jnp.float32)
        _, rc, _ = ref_tfm.forward(params, cfg, None, tokens=jt,
                                   positions=jp, cache=rc, t=jnp.array(0),
                                   mode="prefill")
        for gi, _, reps, idx in port_tfm.group_layers(pcfg):
            g = rc["groups"][f"g{gi}"]
            for r, row in enumerate(idx):
                for i, li in enumerate(row):
                    for name in ("k", "v", "pos"):
                        want = np.asarray(g[f"b{i}"][name])
                        want = want[r] if reps > 1 else want
                        np.testing.assert_allclose(
                            cache[li][name].numpy(), want, atol=ATOL,
                            rtol=RTOL)


def test_greedy_generate_gives_the_reference_tokens():
    cfg, params, pcfg, model = models("qwen2-1.5b")
    jt, tt = tokens(cfg, 8, seed=4)
    want = ref_serve.greedy_generate(params, cfg, None, jt, 6, 24)
    got = port_serve.greedy_generate(model, pcfg, tt, 6, 24)
    assert got.dtype == torch.int32 and got.shape == (B, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_entry_point_picks_the_reference_split(capsys):
    argv = ["--arch", "qwen2-1.5b", "--reduced"]
    want = ref_launch.main(argv)
    got = port_launch.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    pb = port_launch.build_problem(get_config("qwen2-1.5b"), 32)
    rpb = ref_launch.build_problem(ref_get_config("qwen2-1.5b"), 32)
    l, p = pb.denormalize(got.best_a)
    rl, rp = rpb.denormalize(want.best_a)
    assert (l, round(p, 3), got.n_evals) == (rl, round(rp, 3), want.n_evals)
    assert (l, got.n_evals) == (1, 15)
    assert "split l=1/28 P=0.040 W" in out and "(15 evals" in out
