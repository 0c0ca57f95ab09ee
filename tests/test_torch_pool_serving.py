"""Serving of the pool's dense, audio and vision LMs (DeepSeek-7B,
H2O-Danube3-4B, StarCoder2-15B, MusicGen-large, InternVL2-26B) against
the reference on the CPU, in reduced form: the serving entry point picks
the reference's split and power and prints the reference's line;
InternVL2-26B's prefill + one decode step from ``embeds`` equals the full
forward and the reference's decode step, on the reference's parameters
carried across; and the port's ``frontends.fake_embeds`` draws the
reference's shape, dtype and scale, the same tensor from the same seed.

Tolerances: hidden states atol 1e-4, rtol 1e-3 (float32, the reference's
own bar in ``tests/test_integration.py``); split, power, evaluation
counts and the printed line exactly; the embeddings' standard deviation
within 5 % of 0.02 over at least 65,536 draws (its sampling error there
is 0.3 %).
Budget: 90 s on one core (the reference's serving runs are most of it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.launch import serve as ref_launch
from repro.models import frontends as ref_frontends
from repro.models import transformer as ref_tfm
from repro_torch.configs import get_config, reduced
from repro_torch.interop import model_from_reference
from repro_torch.launch import serve as port_launch
from repro_torch.models import frontends
from repro_torch.models import transformer as port_tfm

torch.set_num_threads(1)
ATOL, RTOL = 1e-4, 1e-3
B = 2


def split_line(out: str) -> str:
    (line,) = [s for s in out.splitlines() if " split l=" in s]
    return line


@pytest.mark.parametrize("arch, split", [
    ("deepseek-7b", "split l=1/30 P=0.046 W"),
    ("h2o-danube-3-4b", "split l=1/24 P=0.035 W"),
    ("starcoder2-15b", "split l=1/40 P=0.016 W"),
    ("musicgen-large", "split l=1/48 P=0.063 W"),
    ("internvl2-26b", "split l=1/48 P=0.016 W"),
])
def test_serve_entry_point_picks_the_reference_split(arch, split, capsys):
    argv = ["--arch", arch, "--reduced"]
    want = ref_launch.main(argv)
    ref_out = capsys.readouterr().out
    got = port_launch.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    pb = port_launch.build_problem(get_config(arch), 32)
    rpb = ref_launch.build_problem(ref_get_config(arch), 32)
    l, p = pb.denormalize(got.best_a)
    rl, rp = rpb.denormalize(want.best_a)
    assert (l, round(p, 3), got.n_evals) == (rl, round(rp, 3), want.n_evals)
    assert split_line(out) == split_line(ref_out)
    assert split in split_line(out) and "(15 evals, feasible=True)" in out


def test_internvl2_prefill_then_decode_from_embeds():
    """Prefill 23 positions from embeddings, decode the 24th: equal to the
    port's full forward and to the reference's decode step."""
    cfg = ref_reduced(ref_get_config("internvl2-26b"))
    params = ref_tfm.init_model(jax.random.PRNGKey(0), cfg)
    pcfg = reduced(get_config("internvl2-26b"))
    model = model_from_reference(pcfg, jax.tree.map(np.asarray, params),
                                 "cpu")
    S = 24
    x = (np.random.default_rng(2).standard_normal((B, S, cfg.d_model))
         * 0.02).astype(np.float32)
    p = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    tx, tp = torch.as_tensor(x), torch.as_tensor(p)
    full, _, _ = port_tfm.forward(model, embeds=tx, positions=tp)
    cache = port_tfm.init_cache(pcfg, B, S, dtype=torch.float32,
                                device="cpu")
    port_tfm.forward(model, embeds=tx[:, :S - 1], positions=tp[:, :S - 1],
                     cache=cache, t=0, mode="prefill")
    dec, _, _ = port_tfm.forward(model, embeds=tx[:, S - 1:],
                                 positions=tp[:, S - 1:], cache=cache,
                                 t=S - 1, mode="decode")
    jx, jp = jnp.asarray(x), jnp.asarray(p)
    rc = ref_tfm.init_cache(cfg, B, S, dtype=jnp.float32)
    _, rc, _ = ref_tfm.forward(params, cfg, None, embeds=jx[:, :S - 1],
                               positions=jp[:, :S - 1], cache=rc,
                               t=jnp.array(0), mode="prefill")
    rdec, _, _ = ref_tfm.forward(params, cfg, None, embeds=jx[:, S - 1:],
                                 positions=jp[:, S - 1:], cache=rc,
                                 t=jnp.array(S - 1), mode="decode")
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, S - 1].numpy(),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(dec[:, 0].numpy(), np.asarray(rdec[:, 0]),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("arch", ["musicgen-large", "internvl2-26b"])
@pytest.mark.parametrize("dtype, jdtype", [
    (torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)])
def test_fake_embeds_shape_dtype_and_scale(arch, dtype, jdtype):
    cfg = get_config(arch)
    assert frontends.uses_embeds(cfg)
    seq = -(-65536 // (2 * cfg.d_model))          # 65,536 draws or more
    got = frontends.fake_embeds(torch.Generator().manual_seed(0), cfg, 2,
                                seq, dtype)
    want = ref_frontends.fake_embeds(jax.random.PRNGKey(0),
                                     ref_get_config(arch), 2, seq, jdtype)
    assert tuple(got.shape) == tuple(want.shape) == (2, seq, cfg.d_model)
    assert got.numel() >= 65536 and got.dtype == dtype
    assert str(want.dtype) == str(dtype).split(".")[-1]
    std = float(got.float().std())
    assert abs(std / 0.02 - 1) < 0.05, std
    assert abs(float(np.asarray(want, np.float32).std()) / 0.02 - 1) < 0.05
    assert abs(float(got.float().mean())) < 0.02 * 0.05


def test_fake_embeds_follow_the_seed():
    cfg = get_config("internvl2-26b")

    def draw(seed, **kw):
        return frontends.fake_embeds(torch.Generator().manual_seed(seed),
                                     cfg, 2, 8, **kw)

    assert torch.equal(draw(0), draw(0))
    assert not torch.equal(draw(0), draw(1))
    assert torch.equal(draw(3, dtype=torch.bfloat16),
                       draw(3).to(torch.bfloat16))
    assert draw(0, device="cpu").device.type == "cpu"
