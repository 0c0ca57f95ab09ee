"""The port's plain ``flash_attention`` (what ``ops.flash_attention``
returns for CPU tensors, and what the CUDA kernel is held against on the
card) against the reference's jnp oracle ``attention_ref`` and its Pallas
kernel in interpret mode, on the reference's own kernel cases (MQA, GQA,
windows, ragged S, hd 16-128). Tolerance: the reference's ``_tol``, atol
2e-5 for float32 and 2e-2 for bfloat16, rtol 1e-2."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as ref_kernel
from repro.kernels.flash_attention.ref import attention_ref as ref_oracle
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.flash_attention import ops as flash_ops

torch.set_num_threads(1)
RTOL = 1e-2
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}

FLASH_CASES = [
    # (B, S, Hq, Hkv, hd, window, dtype) — tests/test_kernels.py
    (2, 128, 4, 2, 32, 0, "float32"),
    (1, 256, 8, 8, 64, 0, "float32"),
    (1, 96, 4, 1, 16, 0, "float32"),       # MQA + ragged S
    (2, 128, 4, 4, 32, 24, "float32"),     # sliding window
    (1, 160, 8, 2, 64, 48, "float32"),     # GQA + window + ragged S
    (2, 128, 4, 2, 32, 0, "bfloat16"),
    (1, 64, 2, 2, 128, 0, "bfloat16"),
]


def _inputs(B, S, Hq, Hkv, hd, dt, seed=42):
    """The same numbers for both packages: float32 from numpy, rounded
    to bfloat16 by each package alike (round to nearest even)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd))]
    jx = [jnp.asarray(a).astype(getattr(jnp, dt)) for a in arrs]
    tx = [torch.as_tensor(a).to(getattr(torch, dt)) for a in arrs]
    return jx, tx


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("against", ["jnp_oracle", "pallas_interpret"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_plain_version_matches_reference(case, against):
    B, S, Hq, Hkv, hd, win, dt = case
    (jq, jk, jv), (q, k, v) = _inputs(B, S, Hq, Hkv, hd, dt)
    if against == "jnp_oracle":
        want = ref_oracle(jq, jk, jv, causal=True, window=win)
    else:
        want = ref_kernel(jq, jk, jv, causal=True, window=win, bq=32, bk=32,
                          interpret=True)
    got = flash_attention(q, k, v, causal=True, window=win)
    assert got.shape == (B, S, Hq, hd) and got.dtype == q.dtype
    np.testing.assert_allclose(_f32(got), _f32(want), atol=ATOL[dt],
                               rtol=RTOL)


@pytest.mark.parametrize("causal", [True, False])
def test_non_causal_and_ragged_kv(causal):
    """Sq != Skv and the non-causal mask, against the jnp oracle."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 40, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 72, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, 72, 2, 16)).astype(np.float32)
    want = ref_oracle(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=causal, window=20)
    got = attention_ref(torch.as_tensor(q), torch.as_tensor(k),
                        torch.as_tensor(v), causal=causal, window=20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL["float32"], rtol=RTOL)


def test_cpu_tensors_get_the_plain_version():
    _, (q, k, v) = _inputs(1, 48, 4, 2, 32, "float32", seed=1)
    before = flash_attention.launches
    got = flash_attention(q, k, v, window=16)
    assert torch.equal(got, attention_ref(q, k, v, window=16))
    assert flash_attention.launches == before      # nothing was launched


def test_other_devices_raise():
    """Off the CPU the plain version is never run: meta tensors reach the
    ``repro_torch::flash_attention`` operator, whose shape-only
    implementation gives the output's shape and dtype and launches
    nothing; a tensor that fits no kernel still raises."""
    _, (q, k, v) = _inputs(1, 16, 2, 1, 16, "float32")
    before = flash_attention.launches
    out = flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert out.device.type == "meta" and out.shape == q.shape
    assert out.dtype == q.dtype
    assert flash_attention.launches == before      # nothing was launched
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(*(t[..., :12].to("meta") for t in (q, k, v)))


def _t(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("bad, err", [
    ((_t((1, 8, 4, 12)), _t((1, 8, 2, 12)), _t((1, 8, 2, 12)), 0),
     "multiple of 8"),                                 # hd 12
    ((_t((1, 8, 4, 264)), _t((1, 8, 2, 264)), _t((1, 8, 2, 264)), 0),
     "multiple of 8"),                                 # hd > 256
    ((_t((1, 8, 3, 16)), _t((1, 8, 2, 16)), _t((1, 8, 2, 16)), 0),
     "do not fit"),                                    # Hq % Hkv
    ((_t((1, 8, 4, 16)), _t((1, 8, 2, 16), torch.float16),
      _t((1, 8, 2, 16)), 0), "dtype"),
    ((_t((1, 8, 4, 16)), _t((1, 8, 2, 16)), _t((1, 8, 2, 16)).transpose(
        1, 3).contiguous().transpose(1, 3), 0), "contiguous head dim"),
    ((_t((1, 40, 4, 16)), _t((1, 8, 2, 16)), _t((1, 8, 2, 16)), 16),
     "no key"),                                        # window past Skv
], ids=["hd12", "hd264", "groups", "dtype", "strided_hd", "empty_rows"])
def test_kernel_path_rejects_what_the_kernel_does_not_take(bad, err):
    """The checks the wrapper makes before a launch (device-independent,
    so they run here)."""
    q, k, v, window = bad
    with pytest.raises((ValueError, TypeError), match=err):
        flash_ops._check(q, k, v, window)


def test_kernel_path_accepts_strided_views():
    """Head-first views (strided batch/seq/head dims) are taken as they
    are: the kernel reads strides."""
    q = _t((2, 4, 8, 16)).transpose(1, 2)              # (B, S, H, hd)
    k = _t((2, 2, 8, 16)).transpose(1, 2)
    flash_ops._check(q, k, k, 0)
