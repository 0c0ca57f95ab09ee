"""The port's plain ``decode_attention`` (what ``ops.decode_attention``
returns for CPU tensors, and what the CUDA kernel is held against on the
card) against the reference's jnp oracle ``decode_attention_ref`` and its
Pallas kernel in interpret mode, on the reference's own cases (GQA, MQA,
a ring-window cache, bf16). The port's twin of the reference model's jnp
decode route (``models.attention.decode_attention``) is held against the
reference's. Tolerance: the reference's ``_tol``, atol 2e-5 for float32
and 2e-2 for bfloat16, rtol 1e-2."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as ref_kernel
from repro.kernels.decode_attention.ref import decode_attention_ref as ref_oracle
from repro.models import attention as ref_attn
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref)
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.models import attention as port_attn

torch.set_num_threads(1)
RTOL = 1e-2
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
INT32_MAX = np.iinfo(np.int32).max

DECODE_CASES = [
    # (B, T, Hq, Hkv, hd, filled, window, dtype) — tests/test_kernels.py
    (2, 128, 4, 2, 32, 100, 0, "float32"),
    (1, 256, 8, 1, 64, 256, 0, "float32"),
    (2, 96, 4, 4, 32, 60, 32, "float32"),    # ring-window cache
    (1, 128, 8, 2, 128, 77, 0, "bfloat16"),
]


def _inputs(B, T, Hq, Hkv, hd, filled, dt, seed=7):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, hd), (B, T, Hkv, hd), (B, T, Hkv, hd))]
    kv_pos = np.full((B, T), INT32_MAX, np.int32)
    kv_pos[:, :filled] = np.arange(filled)
    q_pos = np.full((B,), filled, np.int32)
    jx = [jnp.asarray(a).astype(getattr(jnp, dt)) for a in arrs]
    tx = [torch.as_tensor(a).to(getattr(torch, dt)) for a in arrs]
    return (jx + [jnp.asarray(kv_pos), jnp.asarray(q_pos)],
            tx + [torch.as_tensor(kv_pos), torch.as_tensor(q_pos)])


def _ring(B, T, Hq, Hkv, hd, t, window, seed=3):
    """A ring cache of capacity T after writing positions 0..t at slot
    p % T (so it has wrapped when t >= T), queried at position t."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, hd), (B, T, Hkv, hd), (B, T, Hkv, hd))]
    kv_pos = np.full((B, T), INT32_MAX, np.int32)
    for p in range(t + 1):
        kv_pos[:, p % T] = p
    q_pos = np.full((B,), t, np.int32)
    return arrs + [kv_pos, q_pos]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("against", ["jnp_oracle", "pallas_interpret"])
@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
def test_plain_version_matches_reference(case, against):
    B, T, Hq, Hkv, hd, filled, win, dt = case
    jx, tx = _inputs(B, T, Hq, Hkv, hd, filled, dt)
    if against == "jnp_oracle":
        want = ref_oracle(*jx, window=win)
    else:
        want = ref_kernel(*jx, window=win, bk=32, interpret=True)
    got = decode_attention(*tx, window=win)
    assert got.shape == (B, Hq, hd) and got.dtype == tx[0].dtype
    np.testing.assert_allclose(_f32(got), _f32(want), atol=ATOL[dt],
                               rtol=RTOL)


@pytest.mark.parametrize("t, window", [(40, 0), (150, 64), (200, 0)],
                         ids=["partial", "wrapped_window", "wrapped"])
def test_wrapped_ring_matches_reference(t, window):
    """A ring that has wrapped (slot order no longer position order)."""
    arrs = _ring(2, 64, 6, 2, 32, t, window)
    want = ref_oracle(*[jnp.asarray(a) for a in arrs], window=window)
    got = decode_attention(*[torch.as_tensor(a) for a in arrs],
                           window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL["float32"], rtol=RTOL)


@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
def test_model_decode_route_matches_reference(case):
    """``models.attention.decode_attention`` (q (B,1,Hq,hd), q_pos (B,1))
    against the reference model's jnp decode route, and against the
    plain kernel version it shares its mask with."""
    B, T, Hq, Hkv, hd, filled, win, dt = case
    jx, tx = _inputs(B, T, Hq, Hkv, hd, filled, dt, seed=11)
    jq, jk, jv, jkp, jqp = jx
    q, k, v, kp, qp = tx
    want = ref_attn.decode_attention(jq[:, None], jk, jv, jkp, jqp[:, None],
                                     win)
    got = port_attn.decode_attention(q[:, None], k, v, kp, qp[:, None], win)
    assert got.shape == (B, 1, Hq, hd)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=ATOL[dt],
                               rtol=RTOL)
    np.testing.assert_allclose(_f32(got[:, 0]),
                               _f32(decode_attention_ref(q, k, v, kp, qp,
                                                         win)),
                               atol=ATOL[dt], rtol=RTOL)


def test_cpu_tensors_get_the_plain_version():
    _, tx = _inputs(2, 64, 4, 2, 32, 40, "float32", seed=1)
    before = decode_attention.launches
    got = decode_attention(*tx, window=16)
    assert torch.equal(got, decode_attention_ref(*tx, window=16))
    assert decode_attention.launches == before     # nothing was launched


def test_other_devices_raise():
    _, tx = _inputs(1, 16, 2, 1, 16, 8, "float32")
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        decode_attention(*[t.to("meta") for t in tx])


def _args(B=2, T=16, Hq=4, Hkv=2, hd=16, dtype=torch.float32):
    return [torch.zeros(B, Hq, hd, dtype=dtype),
            torch.zeros(B, T, Hkv, hd, dtype=dtype),
            torch.zeros(B, T, Hkv, hd, dtype=dtype),
            torch.zeros(B, T, dtype=torch.int32),
            torch.zeros(B, dtype=torch.int32)]


def _with(i, value, **kw):
    a = _args(**kw)
    a[i] = value
    return a


@pytest.mark.parametrize("bad, err", [
    (_args(hd=12), "multiple of 8"),
    (_args(Hq=3), "do not fit"),
    (_with(3, torch.zeros(2, 16, dtype=torch.int64)), "int32"),
    (_with(4, torch.zeros(3, dtype=torch.int32)), "do not fit"),
    (_with(1, torch.zeros(2, 16, 2, 16, dtype=torch.bfloat16)), "dtype"),
    (_args(Hq=77, Hkv=1, hd=256), "shared memory"),  # the first too big
], ids=["hd12", "groups", "pos_dtype", "qpos_shape", "mixed_dtype",
        "smem"])
def test_kernel_path_rejects_what_the_kernel_does_not_take(bad, err):
    with pytest.raises((ValueError, TypeError), match=err):
        decode_ops._check(*bad, window=0)


def test_kernel_path_accepts_the_model_layout():
    """The model's decode step passes a contiguous cache and q, Qwen2's
    group of 6 q heads at hd 128."""
    decode_ops._check(*_args(Hq=12, Hkv=2, hd=128, dtype=torch.bfloat16),
                      window=0)
