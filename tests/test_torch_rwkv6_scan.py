"""The port's plain ``rwkv6_scan`` (what ``ops.rwkv6_scan`` returns for
CPU tensors, and what the CUDA kernel is held against on the card)
against the reference's sequential oracle ``rwkv6_scan_ref`` and its
Pallas kernel in interpret mode, on the reference's own cases
(``tests/test_kernels.py::RWKV_CASES``: hd 16 and 32, a ragged S of 100,
bf16), a decode step (S = 1, which the reference model runs through its
jnp ``_wkv_scan``) and RWKV6-3B's head dim of 160. Tolerances: float32
atol 1e-4, rtol 1e-4 (the read-out sums r . S and the bonus term in
another order than the oracle's r . (S + u k v)); bfloat16 the
reference's kernel-test bar, 5 x its atol (5 x 2e-2) and rtol 3e-2."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_scan.ops import rwkv6_scan as ref_kernel
from repro.kernels.rwkv6_scan.ref import rwkv6_scan_ref as ref_oracle
from repro.models.rwkv6 import _wkv_scan as ref_model_scan
from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_ref
from repro_torch.kernels.rwkv6_scan import ops as scan_ops

torch.set_num_threads(1)
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (5 * 2e-2, 3e-2)}

CASES = [
    # (B, S, H, hd, chunk, dtype): RWKV_CASES, then a decode step and
    # RWKV6-3B's head dim
    (2, 64, 2, 16, 16, "float32"),
    (1, 100, 4, 32, 32, "float32"),
    (2, 48, 2, 16, 16, "bfloat16"),
    (2, 1, 3, 16, 8, "float32"),
    (1, 5, 2, 160, 8, "float32"),
]


def _inputs(B, S, H, hd, dt, seed=3):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hd)) for _ in range(3))
    logw = -np.exp(rng.standard_normal((B, S, H, hd))) * 0.5
    u = (rng.standard_normal((H, hd)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((B, H, hd, hd)) * 0.1).astype(np.float32)
    seq = (r, k, v, logw)
    jx = [jnp.asarray(x, jnp.float32).astype(getattr(jnp, dt))
          for x in seq] + [jnp.asarray(u), jnp.asarray(s0)]
    tx = [torch.as_tensor(x, dtype=torch.float32).to(getattr(torch, dt))
          for x in seq] + [torch.as_tensor(u), torch.as_tensor(s0)]
    return jx, tx


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("against", ["jnp_oracle", "pallas_interpret"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_version_matches_reference(case, against):
    B, S, H, hd, chunk, dt = case
    jx, tx = _inputs(B, S, H, hd, dt)
    if against == "jnp_oracle":
        want_o, want_s = ref_oracle(*jx)
    else:
        want_o, want_s = ref_kernel(*jx, chunk=chunk, interpret=True)
    o, s_last = rwkv6_scan(*tx)
    assert o.shape == (B, S, H, hd) and o.dtype == tx[0].dtype
    assert s_last.shape == (B, H, hd, hd) and s_last.dtype == torch.float32
    atol, rtol = TOL[dt]
    np.testing.assert_allclose(_f32(o), _f32(want_o), atol=atol, rtol=rtol)
    np.testing.assert_allclose(_f32(s_last), _f32(want_s), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("S", [1, 9])
def test_matches_the_reference_models_scan(S):
    """The reference model's own ``_wkv_scan`` (its decode route)."""
    jx, tx = _inputs(2, S, 2, 16, "float32", seed=6)
    want_o, want_s = ref_model_scan(*jx)
    o, s_last = rwkv6_scan(*tx)
    atol, rtol = TOL["float32"]
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=atol,
                               rtol=rtol)
    np.testing.assert_allclose(s_last.numpy(), np.asarray(want_s),
                               atol=atol, rtol=rtol)


def test_state_written_in_place():
    _, tx = _inputs(2, 7, 2, 16, "float32", seed=5)
    r, k, v, logw, u, s0 = tx
    want_o, want_s = rwkv6_scan_ref(*tx)
    state = s0.clone()
    o, s_last = rwkv6_scan(r, k, v, logw, u, state, s_out=state)
    assert s_last is state
    assert torch.equal(state, want_s) and torch.equal(o, want_o)


def test_cpu_tensors_get_the_plain_version():
    _, tx = _inputs(1, 6, 2, 16, "float32", seed=1)
    before = rwkv6_scan.launches
    o, s_last = rwkv6_scan(*tx)
    want_o, want_s = rwkv6_scan_ref(*tx)
    assert torch.equal(o, want_o) and torch.equal(s_last, want_s)
    assert rwkv6_scan.launches == before        # nothing was launched


def test_other_devices_raise():
    _, tx = _inputs(1, 2, 1, 8, "float32")
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        rwkv6_scan(*[t.to("meta") for t in tx])


def _args(B=2, S=3, H=2, hd=16, dtype=torch.float32):
    seq = [torch.zeros(B, S, H, hd, dtype=dtype) for _ in range(4)]
    return seq + [torch.zeros(H, hd), torch.zeros(B, H, hd, hd), None]


def _with(i, value, **kw):
    a = _args(**kw)
    a[i] = value
    return a


@pytest.mark.parametrize("bad, err", [
    (_with(2, torch.zeros(2, 3, 2, 16, dtype=torch.bfloat16)), "dtype"),
    (_with(3, torch.zeros(2, 4, 2, 16)), "shape|contiguous head"),
    (_with(0, torch.zeros(2, 3, 16, 2).transpose(2, 3)), "contiguous head"),
    (_with(4, torch.zeros(2, 16, dtype=torch.bfloat16)), "float32"),
    (_with(5, torch.zeros(2, 2, 16, 15)), r"\(2, 2, 16, 16\)"),
    (_with(6, torch.zeros(2, 2, 16, 16).transpose(2, 3)),
     "contiguous float32"),
    (_args(hd=264), "head dim"),
], ids=["mixed_dtype", "shape", "strided_head", "u_dtype", "s0_shape",
        "s_out_layout", "hd264"])
def test_kernel_path_rejects_what_the_kernel_does_not_take(bad, err):
    with pytest.raises((ValueError, TypeError), match=err):
        scan_ops._check(*bad)


def test_kernel_path_accepts_the_model_layout():
    """RWKV6-3B's 16 heads of hd 160 in float32, the state as both s0 and
    s_out; a strided batch and step are fine."""
    a = _args(S=4, H=16, hd=160)
    a[0] = torch.zeros(4, 4, 16, 160)[::2]
    a[6] = a[5]
    scan_ops._check(*a)
