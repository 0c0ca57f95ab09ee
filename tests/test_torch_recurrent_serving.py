"""The port's serving path for the recurrent archs, RecurrentGemma
(RG-LRU + local attention) and RWKV6, against the reference on the CPU,
with the reference's initialized parameters carried across: split
serving equals the full forward and the reference's runner, prefill +
one decode step equals the full forward and the reference's decode step
with every layer's state (written in place) equal to the state the
reference returns, greedy decoding gives the reference's tokens exactly,
and the serving entry point picks the reference's split and power.

Tolerances: logits, hidden states and states atol 1e-4, rtol 1e-3
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


RECURRENT_ARCHS = ["recurrentgemma-2b", "rwkv6-3b"]


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_split_runner_matches_full_forward_and_reference(arch):
    cfg, params, pcfg, model = models(arch)
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


def _ref_layer(rc, pcfg, layer):
    """The reference cache entry of global layer ``layer``."""
    for gi, _, reps, idx in port_tfm.group_layers(pcfg):
        for r, row in enumerate(idx):
            if layer in row:
                entry = rc["groups"][f"g{gi}"][f"b{row.index(layer)}"]
                return {k: np.asarray(v)[r] if reps > 1 else np.asarray(v)
                        for k, v in entry.items()}
    raise IndexError(layer)


@pytest.mark.parametrize("arch, S", [("recurrentgemma-2b", 40),
                                     ("rwkv6-3b", 32)],
                         ids=["recurrentgemma_window_ring", "rwkv6"])
def test_recurrent_prefill_then_decode(arch, S):
    """Prefill S - 1 tokens, decode the last: equal to the full forward
    and to the reference's decode step, and each layer's state, written
    in place, equal to the state the reference returns. RecurrentGemma's
    window of 16 makes its local layers wrap their ring."""
    cfg, params, pcfg, model = models(arch)
    jt, tt = tokens(cfg, S, seed=2)
    jp, tp = positions(S)
    full, _, _ = port_tfm.forward(model, tokens=tt, positions=tp,
                                  mode="train")
    cache = port_tfm.init_cache(pcfg, B, S, dtype=torch.float32,
                                device="cpu")
    held = [dict(entry) for entry in cache]      # the tensors, by identity
    port_tfm.forward(model, tokens=tt[:, :S - 1], positions=tp[:, :S - 1],
                     cache=cache, t=0, mode="prefill")
    dec, out_cache, _ = port_tfm.forward(
        model, tokens=tt[:, S - 1:], positions=tp[:, S - 1:], cache=cache,
        t=S - 1, mode="decode")

    rc = ref_tfm.init_cache(cfg, B, S, dtype=jnp.float32)
    _, rc, _ = ref_tfm.forward(params, cfg, None, tokens=jt[:, :S - 1],
                               positions=jp[:, :S - 1], cache=rc,
                               t=jnp.array(0), mode="prefill")
    rdec, rc, _ = ref_tfm.forward(params, cfg, None, tokens=jt[:, S - 1:],
                                  positions=jp[:, S - 1:], cache=rc,
                                  t=jnp.array(S - 1), mode="decode")
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, S - 1].numpy(),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(dec[:, 0].numpy(), np.asarray(rdec[:, 0]),
                               atol=ATOL, rtol=RTOL)
    assert out_cache is cache
    for li, entry in enumerate(cache):
        want = _ref_layer(rc, pcfg, li)
        assert sorted(entry) == sorted(want)
        for name, t in entry.items():
            assert t is held[li][name], (li, name)      # in place
            np.testing.assert_allclose(t.numpy(), want[name], atol=ATOL,
                                       rtol=RTOL, err_msg=f"{li} {name}")


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_greedy_generate_gives_the_reference_tokens(arch):
    cfg, params, pcfg, model = models(arch)
    jt, tt = tokens(cfg, 20, seed=4)
    want = ref_serve.greedy_generate(params, cfg, None, jt, 6, 32)
    got = port_serve.greedy_generate(model, pcfg, tt, 6, 32)
    assert got.dtype == torch.int32 and got.shape == (B, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch, line", [
    ("recurrentgemma-2b", "split l=1/26 P=0.027 W"),
    ("rwkv6-3b", "split l=1/32 P=0.143 W"),
])
def test_recurrent_serve_entry_point_picks_the_reference_split(arch, line,
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
