"""The plain emulation of the float32 flash-attention kernels' products,
on the CPU. The kernels run float32 on the tensor cores as 3xTF32: each
operand x is split into hi = tf32(x) and lo = tf32(x - hi), and a product
a b is formed as lo_a hi_b + hi_a lo_b + hi_a hi_b (``ref.split_tf32``,
``ref._product``). Held here:

- ``tf32_round`` (``cvt.rna.tf32.f32``) on ties, subnormals, the largest
  finite values, inf and nan, and against an independent rounding in
  float64 on random values; ``split_tf32`` within 2^-22 of |x|;
- the forward emulation (``attention_tiled_ref(..., p_dtype=float32,
  products="3xtf32")``) against the reference's float32 attention (its
  jnp oracle and its Pallas kernel in interpret mode) on the reference's
  float32 kernel cases, within the reference's float32 bar (atol 2e-5,
  rtol 1e-2);
- the backward emulation (``attention_bwd_tiled_ref(...,
  products="3xtf32")``) against ``jax.vjp`` of the reference's
  ``attention_ref`` within ``tests/test_torch_flash_backward.py``'s
  float32 bar (1e-5 of each tensor's largest magnitude), at every
  instance width's tiles;
- that single TF32 products (``products="tf32"``, no split) exceed those
  float32 bars on some case, so the bars tell the split from no split;
- the 16-byte alignment the float32 kernels' copies need, refused by the
  wrapper's check.

The CUDA kernels themselves are held against these on the card by
``chip_smoke.py`` phase 2."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as ref_kernel
from repro.kernels.flash_attention.ref import attention_ref as ref_oracle
from repro_torch.kernels.flash_attention import ops, ref

torch.set_num_threads(1)
RTOL, ATOL = 1e-2, 2e-5     # the reference's float32 kernel bar
BWD_TOL = 1e-5              # test_torch_flash_backward.py's float32 bar

# (B, S, Hq, Hkv, hd, window): the reference's float32 kernel cases
# (tests/test_kernels.py), hd 16-64: the 64-wide instance
FWD_CASES = [
    (2, 128, 4, 2, 32, 0),
    (1, 256, 8, 8, 64, 0),
    (1, 96, 4, 1, 16, 0),       # MQA + ragged S
    (2, 128, 4, 4, 32, 24),     # sliding window
    (1, 160, 8, 2, 64, 48),     # GQA + window + ragged S
]
# test_torch_flash_backward.py's float32 cases, and the 128- and 256-wide
# instances' own tiles
BWD_CASES = [
    (2, 64, 4, 2, 32, 0),
    (1, 96, 4, 1, 16, 0),
    (2, 70, 4, 4, 32, 24),
    (1, 100, 8, 2, 64, 48),
    (2, 64, 6, 2, 24, 0),
    (1, 96, 4, 2, 128, 0),
    (1, 80, 2, 1, 256, 40),
]


def _ids(cases):
    return [f"B{c[0]}_S{c[1]}_{c[2]}x{c[3]}_hd{c[4]}_w{c[5]}" for c in cases]


def _bits(x):
    return torch.tensor(np.array(x, np.uint32).view(np.float32))


def _as_bits(t):
    return t.view(torch.int32).numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# the rounding and the split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("given, want", [
    (0x3F800000, 0x3F800000),   # 1: already TF32
    (0x3F801000, 0x3F802000),   # 1 + 2^-11: a tie, away from zero
    (0xBF801000, 0xBF802000),   # -(1 + 2^-11): a tie, away from zero
    (0x3F803000, 0x3F804000),   # 1 + 3 2^-11: a tie, away from zero
    (0x3F800FFF, 0x3F800000),   # just below the tie: down
    (0x3F801001, 0x3F802000),   # just above the tie: up
    (0x3F801FFF, 0x3F802000),
    (0x00000001, 0x00000000),   # the smallest subnormal: to 0
    (0x00001000, 0x00002000),   # a subnormal tie, away from zero
    (0x80001000, 0x80002000),
    (0x007FFFFF, 0x00800000),   # the largest subnormal: the smallest normal
    (0x7F7FE000, 0x7F7FE000),   # the largest TF32 value
    (0x7F7FEFFF, 0x7F7FE000),   # below the tie past it: down
    (0x7F7FF000, 0x7F800000),   # the tie past it: to inf
    (0x7F7FFFFF, 0x7F800000),   # the largest float32: to inf
    (0xFF7FFFFF, 0xFF800000),
    (0x7F800000, 0x7F800000),   # inf
    (0xFF800000, 0xFF800000),   # -inf
    (0x00000000, 0x00000000),   # zeros keep their sign
    (0x80000000, 0x80000000),
])
def test_tf32_round_edges(given, want):
    got = _as_bits(ref.tf32_round(_bits([given])))
    assert got[0] == want, f"{given:#010x} -> {got[0]:#010x}, not {want:#010x}"


def test_tf32_round_keeps_nan():
    x = _bits([0x7FC00000, 0x7F800001, 0xFFC00000])
    assert torch.isnan(ref.tf32_round(x)).all()


def test_tf32_round_matches_float64_rounding():
    """Random normal values over a wide range of exponents, against the
    same rounding done independently: the significand scaled to 11 bits
    in float64, rounded half away from zero."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(20000)
         * np.exp2(rng.integers(-100, 100, 20000))).astype(np.float32)
    m, e = np.frexp(x.astype(np.float64))          # |m| in [0.5, 1)
    want = (np.sign(m) * np.floor(np.abs(m) * 2.0**11 + 0.5)
            * np.exp2(e - 11.0)).astype(np.float32)
    got = ref.tf32_round(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not (_as_bits(torch.as_tensor(got)) & 0x1FFF).any()


def test_split_tf32_is_x_within_2_to_the_minus_22():
    rng = np.random.default_rng(1)
    x = torch.as_tensor((rng.standard_normal(20000)
                         * np.exp2(rng.integers(-60, 60, 20000)))
                        .astype(np.float32))
    hi, lo = ref.split_tf32(x)
    for part in (hi, lo):
        assert not (_as_bits(part) & 0x1FFF).any()      # both TF32
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0**-22 * x.double().abs()).all())
    assert bool((lo.abs() <= 2.0**-11 * x.abs()).all())


def test_products_modes():
    """'float32' is the einsum itself; '3xtf32' and 'tf32' differ from it
    by the split's and one TF32 product's rounding; other names raise."""
    rng = np.random.default_rng(2)
    a, b = (torch.as_tensor(rng.standard_normal((16, 64)).astype(np.float32))
            for _ in range(2))
    exact = a.double() @ b.double().T
    plain = ref._product("ik,jk->ij", a, b)
    assert torch.equal(plain, torch.einsum("ik,jk->ij", a, b))
    scale = float(exact.abs().max())
    split = float((ref._product("ik,jk->ij", a, b, "3xtf32").double()
                   - exact).abs().max()) / scale
    single = float((ref._product("ik,jk->ij", a, b, "tf32").double()
                    - exact).abs().max()) / scale
    assert split < 1e-6 < 1e-4 < single
    with pytest.raises(ValueError, match="products"):
        ref._product("ik,jk->ij", a, b, "bf16")


@pytest.mark.parametrize("hd, fwd, bwd", [
    (16, (64, 64), dict(dkv=(64, 32), dq=(64, 32))),
    (64, (64, 64), dict(dkv=(64, 32), dq=(64, 32))),
    (120, (64, 64), dict(dkv=(64, 32), dq=(64, 32))),
    (256, (64, 32), dict(dkv=(64, 16), dq=(64, 16))),
])
def test_float32_tiles_follow_the_instances(hd, fwd, bwd):
    """The emulations' float32 tiles are ``f32::Cfg``'s of the instance
    that runs hd (64-, 128- or 256-wide)."""
    assert ref.fwd_tiles(hd, torch.float32) == fwd
    assert ref.bwd_tiles(hd, torch.float32) == bwd


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

def _inputs(B, S, Hq, Hkv, hd, seed=42, n=3):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd),
                      (B, S, Hq, hd))[:n]]
    return [jnp.asarray(a) for a in arrs], [torch.as_tensor(a) for a in arrs]


@functools.lru_cache(maxsize=None)
def _fwd_want(case, against):
    B, S, Hq, Hkv, hd, win = case
    jx, _ = _inputs(B, S, Hq, Hkv, hd)
    if against == "jnp_oracle":
        return np.asarray(ref_oracle(*jx, causal=True, window=win))
    return np.asarray(ref_kernel(*jx, causal=True, window=win, bq=32,
                                 bk=32, interpret=True))


@pytest.mark.parametrize("against", ["jnp_oracle", "pallas_interpret"])
@pytest.mark.parametrize("case", FWD_CASES, ids=_ids(FWD_CASES))
def test_split_forward_matches_reference(case, against):
    B, S, Hq, Hkv, hd, win = case
    _, (q, k, v) = _inputs(B, S, Hq, Hkv, hd)
    got = ref.attention_tiled_ref(q, k, v, causal=True, window=win,
                                  p_dtype=torch.float32, products="3xtf32")
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _fwd_want(case, against),
                               atol=ATOL, rtol=RTOL)


def test_single_tf32_forward_breaks_the_float32_bar():
    """Without the split (one TF32 product) the forward leaves the
    reference's float32 bar on some case: the bar tells them apart."""
    worst = 0.0
    for case in FWD_CASES:
        B, S, Hq, Hkv, hd, win = case
        _, (q, k, v) = _inputs(B, S, Hq, Hkv, hd)
        got = ref.attention_tiled_ref(q, k, v, causal=True, window=win,
                                      p_dtype=torch.float32,
                                      products="tf32").numpy()
        want = _fwd_want(case, "jnp_oracle")
        worst = max(worst, float((np.abs(got - want)
                                  - RTOL * np.abs(want)).max()) / ATOL)
    assert worst > 1.0


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("window",))
def _vjp(q, k, v, do, window):
    _, vjp = jax.vjp(lambda q_, k_, v_: ref_oracle(
        q_, k_, v_, causal=True, window=window), q, k, v)
    return vjp(do)


@functools.lru_cache(maxsize=None)
def _bwd_case(case):
    """The reference's gradients, and the float32 kernels' forward
    outputs (the plain forward, which the kernels match in float32)."""
    B, S, Hq, Hkv, hd, win = case
    jx, tx = _inputs(B, S, Hq, Hkv, hd, seed=7, n=4)
    want = [np.asarray(g) for g in _vjp(*jx, window=win)]
    out, lse = ops.flash_attention_fwd(*tx[:3], True, win)
    return tx, out, lse, want


def _rel(got, want):
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


def _bwd_errors(case, products):
    tx, out, lse, want = _bwd_case(case)
    q, k, v, do = tx
    got = ref.attention_bwd_tiled_ref(q, k, v, out, lse, do, True, case[5],
                                      products=products)
    for g, t in zip(got, (q, k, v)):
        assert g.shape == t.shape and g.dtype == torch.float32
    return [_rel(g, w) for g, w in zip(got, want)]


@pytest.mark.parametrize("case", BWD_CASES, ids=_ids(BWD_CASES))
def test_split_backward_matches_reference_vjp(case):
    assert max(_bwd_errors(case, "3xtf32")) <= BWD_TOL


def test_single_tf32_backward_breaks_the_float32_bar():
    worst = max(max(_bwd_errors(case, "tf32")) for case in BWD_CASES)
    assert worst > BWD_TOL


# ---------------------------------------------------------------------------
# what the float32 kernels' 16-byte copies need
# ---------------------------------------------------------------------------

def _offset(shape, by=1):
    n = int(np.prod(shape))
    return torch.zeros(n + by)[by:].view(shape)


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_float32_inputs_must_be_16_byte_aligned(which):
    shapes = dict(q=(1, 8, 4, 16), k=(1, 8, 2, 16), v=(1, 8, 2, 16))
    args = {n: torch.zeros(s) for n, s in shapes.items()}
    ops._check(*args.values(), 0)
    with pytest.raises(ValueError, match=f"float32 {which} must be 16-byte"):
        ops._check(*{**args, which: _offset(shapes[which])}.values(), 0)
    # a head stride of 18 floats is not a multiple of 4 (16 bytes)
    wide = torch.zeros(shapes[which][:3] + (18,))[..., :16]
    with pytest.raises(ValueError, match=f"float32 {which} must be 16-byte"):
        ops._check(*{**args, which: wide}.values(), 0)
    # 20 floats is: a view the copies can read
    view = torch.zeros(shapes[which][:3] + (20,))[..., :16]
    ops._check(*{**args, which: view}.values(), 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_size_one_dim_carries_no_stride(dtype):
    """A dim of size 1 may carry any stride in a contiguous tensor: the
    cotangent that ``einsum``'s backward hands the attention output at
    batch 1 has batch stride 1. The kernels never step along such a dim,
    so the check ignores its stride and the launch passes 0 for it."""
    from repro_torch.kernels.flash_attention import kernel

    o = torch.zeros(1, 64, 4, 32, dtype=dtype, requires_grad=True)
    w = torch.zeros(4, 32, 48, dtype=dtype)
    seen = {}

    class Watch(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            seen["g"] = g
            return g

    torch.einsum("bshk,hkd->bsd", Watch.apply(o), w).sum().backward()
    dout = seen["g"].contiguous()
    assert dout.stride(0) % 4 and dout.is_contiguous()
    assert kernel.strides(dout) == [0, 128, 32]
    lse = torch.zeros(1, 4, 64)
    q = torch.zeros(1, 64, 4, 32, dtype=dtype)
    ops._check_bwd(q, q, q, lse, dout)
    ops._check(dout, q, q, 0)
    # a dim of size more than 1 is still held to 16-byte steps
    pad = 8 // q.element_size()
    bad = torch.zeros(1, 64, 4, 32 + pad, dtype=dtype)[..., :32]
    with pytest.raises(ValueError, match="16-byte"):
        ops._check_bwd(q, q, q, lse, bad)
