"""The port's plain ``rglru_scan`` (what ``ops.rglru_scan`` returns for
CPU tensors, and what the CUDA kernel is held against on the card)
against the reference's associative-scan oracle ``rglru_scan_ref`` and
its Pallas kernel in interpret mode, on the reference's own cases
(``tests/test_kernels.py::RGLRU_CASES``), a decode step (S = 1, against
the reference model's inline update) and a ragged channel count.
Tolerances: float32 atol 2e-5, rtol 1e-5 (the same products associated
in another order); bfloat16 the reference's kernel-test bar, 5 x its
atol (5 x 2e-2) and rtol 3e-2."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan.ops import rglru_scan as ref_kernel
from repro.kernels.rglru_scan.ref import rglru_scan_ref as ref_oracle
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_ref
from repro_torch.kernels.rglru_scan import ops as scan_ops

torch.set_num_threads(1)
TOL = {"float32": (2e-5, 1e-5), "bfloat16": (5 * 2e-2, 3e-2)}

CASES = [
    # (B, S, R, chunk, block_r, dtype): RGLRU_CASES, then a decode step
    # and a ragged R that pads neither S nor R to the TPU's blocks
    (2, 64, 32, 16, 16, "float32"),
    (1, 100, 48, 32, 16, "float32"),
    (2, 64, 32, 16, 32, "bfloat16"),
    (3, 1, 40, 8, 8, "float32"),
    (2, 37, 50, 16, 16, "float32"),
]


def _inputs(B, S, R, dt, seed=9):
    rng = np.random.default_rng(seed)
    a = 1 / (1 + np.exp(-rng.standard_normal((B, S, R))))
    b = rng.standard_normal((B, S, R))
    h0 = rng.standard_normal((B, R)).astype(np.float32)
    jx = [jnp.asarray(x, jnp.float32).astype(getattr(jnp, dt))
          for x in (a, b)] + [jnp.asarray(h0)]
    tx = [torch.as_tensor(x, dtype=torch.float32).to(getattr(torch, dt))
          for x in (a, b)] + [torch.as_tensor(h0)]
    return jx, tx


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("against", ["jnp_oracle", "pallas_interpret"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_version_matches_reference(case, against):
    B, S, R, chunk, br, dt = case
    jx, tx = _inputs(B, S, R, dt)
    if against == "jnp_oracle":
        want_hs, want_h = ref_oracle(*jx)
    else:
        want_hs, want_h = ref_kernel(*jx, chunk=chunk, block_r=br,
                                     interpret=True)
    hs, h_last = rglru_scan(*tx)
    assert hs.shape == (B, S, R) and hs.dtype == tx[0].dtype
    assert h_last.shape == (B, R) and h_last.dtype == torch.float32
    atol, rtol = TOL[dt]
    np.testing.assert_allclose(_f32(hs), _f32(want_hs), atol=atol, rtol=rtol)
    np.testing.assert_allclose(_f32(h_last), _f32(want_h), atol=atol,
                               rtol=rtol)


def test_decode_step_is_the_reference_models_update():
    """S = 1: the reference model computes ``a * h0 + b`` inline
    (``models/rglru.py``); the port routes it through the scan."""
    jx, tx = _inputs(2, 1, 24, "float32", seed=4)
    a, b, h0 = (np.asarray(x) for x in jx)
    want = a[:, 0] * h0 + b[:, 0]
    hs, h_last = rglru_scan(*tx)
    np.testing.assert_allclose(hs[:, 0].numpy(), want, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(h_last.numpy(), want, atol=1e-6, rtol=1e-6)


def test_state_written_in_place():
    _, (a, b, h0) = _inputs(2, 20, 16, "float32", seed=5)
    want_hs, want_h = rglru_scan_ref(a, b, h0)
    state = h0.clone()
    hs, h_last = rglru_scan(a, b, state, h_out=state)
    assert h_last is state
    assert torch.equal(state, want_h) and torch.equal(hs, want_hs)


def test_cpu_tensors_get_the_plain_version():
    _, tx = _inputs(2, 12, 16, "float32", seed=1)
    before = rglru_scan.launches
    hs, h_last = rglru_scan(*tx)
    want_hs, want_h = rglru_scan_ref(*tx)
    assert torch.equal(hs, want_hs) and torch.equal(h_last, want_h)
    assert rglru_scan.launches == before        # nothing was launched


def test_other_devices_raise():
    _, tx = _inputs(1, 4, 8, "float32")
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        rglru_scan(*[t.to("meta") for t in tx])


def _args(B=2, S=5, R=8, dtype=torch.float32):
    return [torch.zeros(B, S, R, dtype=dtype), torch.zeros(B, S, R,
                                                           dtype=dtype),
            torch.zeros(B, R), None]


def _with(i, value, **kw):
    a = _args(**kw)
    a[i] = value
    return a


@pytest.mark.parametrize("bad, err", [
    (_with(1, torch.zeros(2, 5, 8, dtype=torch.bfloat16)), "dtype"),
    (_args(dtype=torch.float16), "dtype"),
    (_with(1, torch.zeros(2, 6, 8)), "shape"),
    (_with(0, torch.zeros(2, 8, 5).transpose(1, 2)), "contiguous channel"),
    (_with(2, torch.zeros(2, 8, dtype=torch.bfloat16)), "float32"),
    (_with(2, torch.zeros(2, 9)), r"\(B,R\)"),
    (_with(3, torch.zeros(8, 2).t()), "contiguous float32"),
], ids=["mixed_dtype", "fp16", "shape", "strided_channel", "h0_dtype",
        "h0_shape", "h_out_layout"])
def test_kernel_path_rejects_what_the_kernel_does_not_take(bad, err):
    with pytest.raises((ValueError, TypeError), match=err):
        scan_ops._check(*bad)


def test_kernel_path_accepts_the_model_layout():
    """The model passes float32 a and b (a strided batch is fine) and
    its state's ``h`` as both h0 and h_out."""
    a = torch.zeros(2, 7, 2560)
    h = torch.zeros(2, 2560)
    scan_ops._check(a, torch.zeros(4, 7, 2560)[::2], h, h)
    scan_ops._check(a.bfloat16(), a.bfloat16(), h, None)
