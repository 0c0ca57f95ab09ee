"""What surrounds the port's two attention kernels, on the CPU: the split
planner of ``decode_attention`` (``ops.decode_splits``), the plain
emulations of the kernels' own arithmetic (``decode_attention_split_ref``:
splits, skipped sub-tiles, the merge; ``attention_tiled_ref``: key tiles,
an online softmax in exp2, P rounded to bf16 before P V) held against the
reference's jnp oracles and its Pallas kernels in interpret mode, and the
alignment the kernels' 16-byte copies need. Tolerance: the reference's
``_tol``, atol 2e-5 for float32 and 2e-2 for bfloat16, rtol 1e-2."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as ref_decode
from repro.kernels.decode_attention.ref import (
    decode_attention_ref as ref_decode_oracle)
from repro.kernels.flash_attention.ops import flash_attention as ref_flash
from repro.kernels.flash_attention.ref import (
    attention_ref as ref_flash_oracle)
from repro_torch.kernels.decode_attention import kernel as decode_kernel
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ops import decode_splits
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, decode_attention_split_ref)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     attention_tiled_ref)

torch.set_num_threads(1)
RTOL = 1e-2
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
INT32_MAX = np.iinfo(np.int32).max


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# the split planner
# ---------------------------------------------------------------------------

PLAN_SHAPES = [(B, Hkv, T) for B in (1, 2, 8, 64) for Hkv in (1, 2, 8)
               for T in (1, 16, 31, 32, 33, 100, 256, 1024, 4096)]


@pytest.mark.parametrize("B, Hkv, T", PLAN_SHAPES, ids=str)
def test_decode_splits_cut_the_cache(B, Hkv, T):
    """Every split holds a whole number of 32-slot sub-tiles and at least
    one slot; the splits cover T exactly once; a split holds at least 32
    slots unless the cache is smaller; the grid stays near one wave."""
    n, chunk = decode_splits(B, Hkv, T)
    sub = decode_kernel.SUB_TILE
    assert isinstance(n, int) and isinstance(chunk, int)
    assert chunk % sub == 0 and chunk >= sub
    assert (n - 1) * chunk < T <= n * chunk
    assert 1 <= n <= max(1, T // sub)
    waves = -(-B * Hkv * n // decode_ops.SMS)
    assert n == 1 or waves <= 2


@pytest.mark.parametrize("B, Hkv, T, want", [
    (2, 2, 1024, (32, 32)),     # Qwen2-1.5B's decode step: 128 blocks
    (2, 1, 1024, (32, 32)),     # RecurrentGemma-2B's local layers: 64
    (2, 2, 256, (8, 32)),
    (1, 1, 100, (2, 64)),
    (64, 8, 4096, (1, 4096)),   # 512 rows fill the card alone
], ids=str)
def test_decode_splits_at_known_shapes(B, Hkv, T, want):
    assert decode_splits(B, Hkv, T) == want
    if B * Hkv < decode_ops.SMS and T >= 64:
        assert B * Hkv * want[0] > B * Hkv   # more blocks than rows


def test_decode_splits_depend_on_shapes_alone():
    """The planner sees the batch, kv heads and cache length, nothing of
    the data, so a result never depends on which slots are filled."""
    assert list(inspect.signature(decode_splits).parameters) == [
        "B", "Hkv", "T"]
    assert decode_splits(2, 2, 1024) == decode_splits(2, 2, 1024)


# ---------------------------------------------------------------------------
# the split-T emulation against the reference
# ---------------------------------------------------------------------------


def _ring(B, T, Hq, Hkv, hd, last, q_pos, dt, seed=5):
    """A ring cache of T slots after writing positions 0..last at slot
    p % T, queried at q_pos (per row, or one for all)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, hd), (B, T, Hkv, hd), (B, T, Hkv, hd))]
    kv_pos = np.full((B, T), INT32_MAX, np.int32)
    for p in range(max(0, last - T + 1), last + 1):
        kv_pos[:, p % T] = p
    q_pos = np.broadcast_to(np.asarray(q_pos, np.int32), (B,)).copy()
    jx = ([jnp.asarray(a).astype(getattr(jnp, dt)) for a in arrs]
          + [jnp.asarray(kv_pos), jnp.asarray(q_pos)])
    tx = ([torch.as_tensor(a).to(getattr(torch, dt)) for a in arrs]
          + [torch.as_tensor(kv_pos), torch.as_tensor(q_pos)])
    return jx, tx


SPLIT_CASES = {
    # name: (B, T, Hq, Hkv, hd, last, q_pos, window)
    "wrapped_ring": (2, 64, 6, 2, 32, 200, 200, 0),
    "wrapped_window": (2, 64, 6, 2, 32, 150, 150, 40),
    "dead_splits": (1, 256, 4, 1, 64, 39, 39, 0),
    "window_middle": (1, 256, 4, 2, 32, 255, 200, 48),
    "no_allowed_slot": (1, 128, 4, 2, 32, 100, -1, 0),
    "one_row_dead": (2, 128, 6, 2, 32, 90, [90, -5], 0),
}


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_emulation_matches_reference(case, dt):
    """At every split count, from one split to one per sub-tile, and at
    the planner's, the split-T arithmetic gives the reference's jnp
    oracle and its Pallas kernel in interpret mode."""
    B, T, Hq, Hkv, hd, last, qp, win = SPLIT_CASES[case]
    jx, tx = _ring(B, T, Hq, Hkv, hd, last, qp, dt)
    oracle = _f32(ref_decode_oracle(*jx, window=win))
    pallas = _f32(ref_decode(*jx, window=win, bk=32, interpret=True))
    splits = {1, 2, T // 32, decode_splits(B, Hkv, T)[0]}
    for n in sorted(splits):
        got = decode_attention_split_ref(*tx, window=win, n_split=n)
        assert got.shape == (B, Hq, hd) and got.dtype == tx[0].dtype
        for want in (oracle, pallas):
            np.testing.assert_allclose(_f32(got), want, atol=ATOL[dt],
                                       rtol=RTOL, err_msg=f"{n} splits")


def test_split_emulation_of_a_dead_row_is_the_mean_of_v():
    """No allowed slot: every slot weighs alike, as in the plain version,
    whichever splits and sub-tiles the row is cut into."""
    _, tx = _ring(1, 96, 4, 1, 16, 50, -1, "float32")
    want = tx[2].float().mean(dim=1).repeat_interleave(4, dim=1)
    for n in (1, 2, 3):
        got = decode_attention_split_ref(*tx, n_split=n)
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(decode_attention_ref(*tx), want, atol=1e-6,
                               rtol=1e-6)


def test_split_emulation_rejects_a_cut_that_leaves_a_split_empty():
    _, tx = _ring(1, 64, 2, 1, 16, 10, 10, "float32")
    with pytest.raises(ValueError, match="do not cut"):
        decode_attention_split_ref(*tx, n_split=3, chunk=32)


# ---------------------------------------------------------------------------
# the tiled flash emulation against the reference
# ---------------------------------------------------------------------------

TILED_CASES = [
    # (B, S, Hq, Hkv, hd, window): the reference's bf16 kernel cases, then
    # the port's instances: 128- and 256-wide tiles, hd 120, windows
    (2, 128, 4, 2, 32, 0),
    (1, 64, 2, 2, 128, 0),
    (1, 200, 4, 2, 128, 0),
    (1, 160, 4, 1, 256, 48),
    (2, 100, 6, 2, 120, 0),
    (1, 96, 2, 1, 64, 32),
]


def _flash_inputs(B, Sq, Skv, Hq, Hkv, hd, dt, seed=42):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, Hq, hd), (B, Skv, Hkv, hd), (B, Skv, Hkv, hd))]
    jx = [jnp.asarray(a).astype(getattr(jnp, dt)) for a in arrs]
    tx = [torch.as_tensor(a).to(getattr(torch, dt)) for a in arrs]
    return jx, tx


@pytest.mark.parametrize("case", TILED_CASES, ids=str)
def test_tiled_bf16_emulation_matches_reference(case):
    """P rounded to bf16 before P V, the kernel's one rounding that the
    plain version does not have, stays inside the unchanged bf16
    tolerance of the reference's jnp oracle."""
    B, S, Hq, Hkv, hd, win = case
    (jq, jk, jv), (q, k, v) = _flash_inputs(B, S, S, Hq, Hkv, hd,
                                            "bfloat16")
    got = attention_tiled_ref(q, k, v, causal=True, window=win)
    assert got.shape == (B, S, Hq, hd) and got.dtype == torch.bfloat16
    want = ref_flash_oracle(jq, jk, jv, causal=True, window=win)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=ATOL["bfloat16"],
                               rtol=RTOL)


@pytest.mark.parametrize("case", TILED_CASES[:2], ids=str)
def test_tiled_bf16_emulation_matches_pallas(case):
    B, S, Hq, Hkv, hd, win = case
    (jq, jk, jv), (q, k, v) = _flash_inputs(B, S, S, Hq, Hkv, hd,
                                            "bfloat16")
    got = attention_tiled_ref(q, k, v, causal=True, window=win)
    want = ref_flash(jq, jk, jv, causal=True, window=win, bq=32, bk=32,
                     interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=ATOL["bfloat16"],
                               rtol=RTOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", TILED_CASES, ids=str)
def test_tiled_emulation_without_rounding_is_the_plain_version(case, causal):
    """With P kept in float32 the tiles, the skipped tiles, the exp2
    softmax and the masks give the plain version to float32 rounding, for
    ragged Skv as well (Skv = S + 24)."""
    B, S, Hq, Hkv, hd, win = case
    if win and not causal:
        win = 0
    _, (q, k, v) = _flash_inputs(B, S, S + 24, Hq, Hkv, hd, "float32",
                                 seed=3)
    got = attention_tiled_ref(q, k, v, causal=causal, window=win,
                              p_dtype=torch.float32)
    want = attention_ref(q, k, v, causal=causal, window=win)
    torch.testing.assert_close(got, want, atol=ATOL["float32"], rtol=RTOL)


# ---------------------------------------------------------------------------
# what the kernels' 16-byte copies need
# ---------------------------------------------------------------------------


def _offset(shape, dtype, by=1):
    """A tensor whose data starts ``by`` elements past its storage."""
    n = int(np.prod(shape))
    return torch.zeros(n + by, dtype=dtype)[by:].view(shape)


def _bf16(shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("bad", [
    (_offset((1, 8, 4, 16), torch.bfloat16), _bf16((1, 8, 2, 16)),
     _bf16((1, 8, 2, 16))),
    (_bf16((1, 8, 4, 16)), _offset((1, 8, 2, 16), torch.bfloat16),
     _bf16((1, 8, 2, 16))),
    (_bf16((1, 8, 4, 20))[..., :16], _bf16((1, 8, 2, 16)),
     _bf16((1, 8, 2, 16))),
    (_bf16((1, 8, 4, 16)), _bf16((1, 8, 2, 16)),
     _bf16((1, 8, 36))[:, :, :32].unflatten(-1, (2, 16))),
], ids=["q_base", "k_base", "q_head_stride", "v_seq_stride"])
def test_flash_rejects_bf16_that_is_not_16_byte_aligned(bad):
    with pytest.raises(ValueError, match="16-byte"):
        flash_ops._check(*bad, 0)


def test_flash_takes_aligned_bf16_views_and_unaligned_float32():
    """Head-first bf16 views with 16-byte strides pass, as the model's
    tensors do. float32 runs on the tensor cores with the same 16-byte
    copies: a stride of 4 floats is a 16-byte step, which bf16's rule of
    8 elements would not take, and passes; a base that is not 16-byte
    aligned raises."""
    q = _bf16((2, 4, 8, 16)).transpose(1, 2)
    k = _bf16((2, 2, 8, 16)).transpose(1, 2)
    flash_ops._check(q, k, k, 0)
    kf = torch.zeros(1, 8, 2, 16)
    f = torch.zeros(1, 8, 4, 20)[..., :16]
    assert f.stride(2) % 8 and not f.stride(2) % 4
    flash_ops._check(f, kf, kf, 0)
    with pytest.raises(ValueError, match="16-byte"):
        flash_ops._check(_offset((1, 8, 4, 16), torch.float32), kf, kf, 0)


def _decode_args(T=32, Hq=4, Hkv=2, hd=16, dtype=torch.bfloat16):
    return [torch.zeros(2, Hq, hd, dtype=dtype),
            torch.zeros(2, T, Hkv, hd, dtype=dtype),
            torch.zeros(2, T, Hkv, hd, dtype=dtype),
            torch.zeros(2, T, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32)]


@pytest.mark.parametrize("i, bad", [
    (1, _offset((2, 32, 2, 16), torch.bfloat16)),
    (2, _offset((2, 32, 2, 16), torch.bfloat16, by=4)),
    (1, torch.zeros(2, 32, 3, 20, dtype=torch.bfloat16)[:, :, :2, :16]),
    (2, torch.zeros(2, 32, 2, 18)[..., :16]),
], ids=["k_base", "v_base", "k_strides", "v_f32_strides"])
def test_decode_rejects_a_cache_that_is_not_16_byte_aligned(i, bad):
    args = _decode_args(dtype=bad.dtype)
    args[i] = bad
    with pytest.raises(ValueError, match="16-byte"):
        decode_ops._check(*args, window=0)


def test_decode_takes_an_unaligned_q():
    """q is read once per block, element by element: it needs no
    alignment."""
    args = _decode_args()
    args[0] = _offset((2, 4, 16), torch.bfloat16)
    decode_ops._check(*args, window=0)


def test_decode_rejects_an_empty_cache():
    with pytest.raises(ValueError, match="one slot"):
        decode_ops._check(*_decode_args(T=0), window=0)


@pytest.mark.parametrize("dtype, hd, fits", [
    (torch.float32, 256, 76), (torch.bfloat16, 256, 91),
    (torch.bfloat16, 128, 185), (torch.float32, 64, 331),
], ids=str)
def test_decode_group_limit_follows_the_shared_memory(dtype, hd, fits):
    """The largest q-head group a block takes, from ``smem_bytes``: K and
    V sub-tiles in the input type, q and the accumulator in float32."""
    size = torch.tensor([], dtype=dtype).element_size()
    assert (decode_kernel.smem_bytes(hd, fits, size)
            <= decode_kernel.SMEM_LIMIT
            < decode_kernel.smem_bytes(hd, fits + 1, size))
    decode_ops._check(*_decode_args(Hq=fits, Hkv=1, hd=hd, dtype=dtype),
                      window=0)
    with pytest.raises(ValueError, match="shared memory"):
        decode_ops._check(*_decode_args(Hq=fits + 1, Hkv=1, hd=hd,
                                        dtype=dtype), window=0)
