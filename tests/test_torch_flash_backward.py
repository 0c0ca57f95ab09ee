"""The port's flash-attention backward on the CPU: the plain backward
(``attention_bwd_ref``, autograd through ``attention_ref``) and the plain
emulation of the backward kernel's arithmetic (``attention_bwd_tiled_ref``:
tiles, P recomputed from the forward's base-2 log-sum-exp, D from the
rounded output) against ``jax.vjp`` of the reference's ``attention_ref``
(``repro/kernels/flash_attention/ref.py``), over causal, windowed, GQA,
MQA, ragged and bfloat16 cases; the forward's second output
(``attention_lse_ref``) against the reference's log-sum-exp; the
autograd ``Function`` on CPU tensors giving the plain gradients; and the
paths that need the card raising here. The CUDA kernel itself is held
against these on the card by ``chip_smoke.py`` phase 2.

Tolerances, of each tensor's largest magnitude: float32 within 1e-5 (the
same sums in another order). bfloat16 inputs are held to the
reference's float32 gradient on the same rounded inputs: the plain
backward on float32 copies within 1e-5, and the bfloat16 gradients of
the plain backward and the emulation within 4e-3 (their outputs round
once to bf16, 2^-8 relative, and the emulation's D uses the bf16
output). The emulation with P and dS rounded to bf16 (the tensor-core
kernels' arithmetic) is held within 8e-3: see
``test_rounded_emulation_matches_reference_vjp``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_attention
from repro_torch.kernels import autograd as kernel_autograd
from repro_torch.kernels.flash_attention import ops, ref

torch.set_num_threads(1)
F32_TOL = 1e-5
BF16_OUT_TOL = 4e-3

CASES = [
    # (B, S, Hq, Hkv, hd, window, dtype)
    (2, 64, 4, 2, 32, 0, "float32"),      # GQA
    (1, 96, 4, 1, 16, 0, "float32"),      # MQA, S not a multiple of a tile
    (2, 70, 4, 4, 32, 24, "float32"),     # sliding window, ragged
    (1, 100, 8, 2, 64, 48, "float32"),    # GQA + window + ragged
    (2, 64, 6, 2, 24, 0, "float32"),      # hd 24: not a power of two
    (2, 48, 4, 2, 32, 0, "bfloat16"),
    (1, 40, 4, 1, 64, 16, "bfloat16"),
]
# the tensor-core kernels' arithmetic: the bf16 CASES, and hd 128 and 256
# (their instances' own tiles: 32 and 16 rows a step)
ROUNDED_CASES = [c for c in CASES if c[6] == "bfloat16"] + [
    (1, 96, 4, 2, 128, 0, "bfloat16"),
    (1, 80, 2, 1, 256, 40, "bfloat16"),
]
BF16_ROUNDED_TOL = 8e-3


def _ids(cases):
    return [f"B{c[0]}_S{c[1]}_{c[2]}x{c[3]}_hd{c[4]}_w{c[5]}_{c[6]}"
            for c in cases]


IDS = _ids(CASES)


def _inputs(B, S, Hq, Hkv, hd, dt, seed=7):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd),
                      (B, S, Hq, hd))]
    tx = [torch.as_tensor(a).to(getattr(torch, dt)) for a in arrs]
    # the reference sees the same rounded numbers, in float32
    jx = [jnp.asarray(t.float().numpy()) for t in tx]
    return jx, tx


@functools.partial(jax.jit, static_argnames=("causal", "window"))
def _vjp(q, k, v, do, causal, window):
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_attention(
        q_, k_, v_, causal=causal, window=window), q, k, v)
    return vjp(do)


@functools.lru_cache(maxsize=None)
def _case_grads(case):
    B, S, Hq, Hkv, hd, window, dt = case
    jx, _ = _inputs(B, S, Hq, Hkv, hd, dt)
    return [np.asarray(g) for g in _vjp(*jx, causal=True, window=window)]


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_reference_vjp(case):
    B, S, Hq, Hkv, hd, window, dt = case
    _, tx = _inputs(B, S, Hq, Hkv, hd, dt)
    want = _case_grads(case)
    got = ref.attention_bwd_ref(*tx, causal=True, window=window)
    for g, t in zip(got, tx):
        assert g.dtype == t.dtype and g.shape == t.shape
    # bf16 outputs round once: compare the float32 plain backward there
    exact = ref.attention_bwd_ref(*(t.float() for t in tx), causal=True,
                                  window=window)
    for g, w in zip(exact, want):
        assert _rel(g, w) <= F32_TOL
    tol = F32_TOL if dt == "float32" else BF16_OUT_TOL
    for g, w in zip(got, want):
        assert _rel(g, w) <= tol


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tiled_emulation_matches_reference_vjp(case):
    """The kernel's own arithmetic, on the forward's outputs."""
    B, S, Hq, Hkv, hd, window, dt = case
    _, tx = _inputs(B, S, Hq, Hkv, hd, dt)
    q, k, v, do = tx
    out, lse = ops.flash_attention_fwd(q, k, v, True, window)
    got = ref.attention_bwd_tiled_ref(q, k, v, out, lse, do, True, window)
    want = _case_grads(case)
    tol = F32_TOL if dt == "float32" else BF16_OUT_TOL
    for g, w, t in zip(got, want, tx):
        assert g.dtype == t.dtype
        assert _rel(g, w) <= tol


@pytest.mark.parametrize("case", ROUNDED_CASES, ids=_ids(ROUNDED_CASES))
def test_rounded_emulation_matches_reference_vjp(case):
    """The emulation of the bfloat16 kernels' arithmetic: P rounded to
    bf16 before dV += P^T dO and dS before dq and dk, on their tiles.
    Against the reference's float32 gradient on the same rounded inputs,
    two bf16 roundings of 2^-8 relative each bound it: 2 x 2^-8 = 7.8e-3,
    so 8e-3 (the worst of 32 draws of four small shapes, 8 seeds each,
    was 6.6e-3). Each output is also within 8e-3 of the unrounded
    emulation: the two differ by those roundings only."""
    B, S, Hq, Hkv, hd, window, dt = case
    _, tx = _inputs(B, S, Hq, Hkv, hd, dt)
    q, k, v, do = tx
    out, lse = ops.flash_attention_fwd(q, k, v, True, window)
    got = ref.attention_bwd_tiled_ref(q, k, v, out, lse, do, True, window,
                                      p_dtype=torch.bfloat16)
    plain = ref.attention_bwd_tiled_ref(q, k, v, out, lse, do, True, window)
    want = _case_grads(case)
    for g, p, w, t in zip(got, plain, want, tx):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert _rel(g, w) <= BF16_ROUNDED_TOL
        assert _rel(g, p.float().numpy()) <= BF16_ROUNDED_TOL
        assert not torch.equal(g, p)    # the roundings took place


@pytest.mark.parametrize("hd,tiles", [
    (64, dict(dkv=(64, 32), dq=(64, 64))),
    (112, dict(dkv=(64, 32), dq=(64, 32))),
    (256, dict(dkv=(64, 16), dq=(64, 16))),
])
def test_bwd_tiles_follow_the_instances(hd, tiles):
    """The emulation's tiles are the tensor-core instance's (hd 64, 128,
    256: hd 112 runs in the 128-wide one) for bfloat16, and the float32
    instance's (64 keys or rows a block, steps of 32 up to hd 128 and 16
    above) for float32."""
    assert ref.bwd_tiles(hd, torch.bfloat16) == tiles
    step = 32 if hd <= 128 else 16
    assert ref.bwd_tiles(hd, torch.float32) == dict(dkv=(64, step),
                                                    dq=(64, step))


@pytest.mark.parametrize("name", ["out", "dout"])
def test_check_bwd_refuses_misaligned_bf16(name):
    """bfloat16 ``out`` and ``dout`` feed the tensor-core kernels' 16-byte
    copies: a base that is not 16-byte aligned or a stride that is not a
    multiple of 8 elements raises, as for q, k and v. float32 runs on the
    tensor cores with the same copies: a base that is not 16-byte aligned
    raises, a stride of 4 floats (16 bytes) passes."""
    B, S, Hq, hd = 1, 8, 2, 16
    q = torch.zeros(B, S, Hq, hd, dtype=torch.bfloat16)
    lse = torch.zeros(B, Hq, S)
    good = dict(out=torch.zeros_like(q), dout=torch.zeros_like(q))
    ops._check_bwd(q, q, good["out"], lse, good["dout"])
    shifted = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)[1:].view(
        q.shape)
    with pytest.raises(ValueError, match=f"bfloat16 {name}"):
        ops._check_bwd(q, q, **{**good, name: shifted}, lse=lse)
    wide = torch.zeros(B, S, Hq, hd + 4, dtype=torch.bfloat16)[..., :hd]
    assert wide.stride(-1) == 1 and wide.stride(2) % 8
    with pytest.raises(ValueError, match=f"bfloat16 {name}"):
        ops._check_bwd(q, q, **{**good, name: wide}, lse=lse)
    q32, o32 = q.float(), torch.zeros(q.numel() + 1)[1:].view(q.shape)
    good32 = dict(out=q32, dout=q32)
    with pytest.raises(ValueError, match=f"float32 {name}"):
        ops._check_bwd(q32, q32, **{**good32, name: o32}, lse=lse)
    wide32 = torch.zeros(B, S, Hq, hd + 4)[..., :hd]
    assert wide32.stride(2) % 8 and not wide32.stride(2) % 4
    ops._check_bwd(q32, q32, **{**good32, name: wide32}, lse=lse)


@pytest.mark.parametrize("causal", [True, False])
def test_lse_matches_reference_logsumexp(causal):
    """The forward's second output: each row's log-sum-exp of the masked
    scores, in base 2, (B, Hq, Sq)."""
    B, S, Hq, Hkv, hd = 2, 50, 4, 2, 32
    jx, tx = _inputs(B, S, Hq, Hkv, hd, "float32")
    q, k = jx[0], jx[1]
    qf = q.reshape(B, S, Hkv, Hq // Hkv, hd)
    s = jnp.einsum("bqhgd,bkhd->bhgqk", qf, k) / jnp.sqrt(hd)
    i = jnp.arange(S)
    mask = (i[None, :] <= i[:, None]) if causal else jnp.ones((S, S), bool)
    mask = mask & (i[:, None] - i[None, :] < 20)
    s = jnp.where(mask, s, -1e30)
    want = np.asarray(jax.jit(jax.scipy.special.logsumexp,
                              static_argnames="axis")(s, axis=-1)
                      ).reshape(B, Hq, S) * np.log2(np.e)
    got = ref.attention_lse_ref(tx[0], tx[1], causal=causal, window=20)
    assert got.shape == (B, Hq, S) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    out, lse = ops.flash_attention_fwd(tx[0], tx[1], tx[2], causal, 20)
    assert torch.equal(lse, got)
    assert torch.equal(out, ref.attention_ref(*tx[:3], causal=causal,
                                              window=20))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_autograd_on_cpu_gives_the_plain_gradients(dt):
    """``flash_attention`` on CPU tensors that require grad is the plain
    version under autograd; ``flash_attention_bwd`` on CPU tensors is
    the plain backward."""
    _, tx = _inputs(2, 40, 4, 2, 16, dt)
    q, k, v, do = tx
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=True, window=12)
    out.backward(do)
    want = ref.attention_bwd_ref(q, k, v, do, causal=True, window=12)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    o, lse = ops.flash_attention_fwd(q, k, v, True, 12)
    got = ops.flash_attention_bwd(q, k, v, o, lse, do.transpose(1, 2)
                                  .contiguous().transpose(1, 2), True, 12)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_paths_that_need_the_card_raise_here():
    """No CUDA here: off the CPU nothing runs the plain version. Meta
    tensors reach the kernels' operators, whose shape-only
    implementations give the outputs' shapes and launch nothing; the
    recurrent scans under grad go through their ``autograd.Function``s
    there as on the card, and refuse an in-place state or a bfloat16 call
    that autograd would record."""
    from repro_torch.kernels import launch_counts
    before = launch_counts()
    q = torch.empty(1, 8, 2, 16, device="meta")
    out, lse = ops.flash_attention_fwd(q, q[:, :, :1], q[:, :, :1])
    assert out.shape == q.shape and lse.shape == (1, 2, 8)
    dq, dk, dv = ops.flash_attention_bwd(q, q, q, q, lse, q)
    assert dq.shape == dk.shape == dv.shape == q.shape
    a = torch.empty(2, 5, 8, device="meta", requires_grad=True)
    assert kernel_autograd.needs_backward(a)
    with torch.no_grad():
        assert not kernel_autograd.needs_backward(a)
    assert not kernel_autograd.needs_backward(a.detach(), None)
    from repro_torch.kernels import rglru_scan, rwkv6_scan
    h0 = torch.empty(2, 8, device="meta")
    hs, _ = rglru_scan(a, a, h0)
    assert hs.grad_fn is not None and hs.shape == a.shape
    with pytest.raises(ValueError, match="h_out"):
        rglru_scan(a, a, h0, h_out=h0)
    with pytest.raises(TypeError, match="bfloat16"):
        rglru_scan(a.bfloat16(), a.bfloat16(), h0)
    r = torch.empty(1, 3, 2, 4, device="meta", requires_grad=True)
    u, s0 = torch.empty(2, 4, device="meta"), torch.empty(1, 2, 4, 4,
                                                         device="meta")
    o, _ = rwkv6_scan(r, r, r, r, u, s0)
    assert o.grad_fn is not None and o.shape == r.shape
    (ga,) = torch.autograd.grad(hs.sum() + o.sum(), [a])
    assert ga.shape == a.shape
    with pytest.raises(ValueError, match="s_out"):
        rwkv6_scan(r, r, r, r, u, s0, s_out=s0)
    with pytest.raises(TypeError, match="bfloat16"):
        rwkv6_scan(*(r.bfloat16(),) * 4, u, s0)
    # without grad the call reaches the operator as well
    with torch.no_grad():
        hs, h_last = rglru_scan(a, a, h0)
    assert hs.grad_fn is None and h_last.shape == h0.shape
    assert launch_counts() == before             # nothing was launched
