"""The CUDA ``rglru_scan``'s plan and order of operations, on the CPU.

``ops.scan_plan`` gives, from shapes alone, what ``rglru_scan.cu``
launches: 16 channels a block, S in chunks of 8 steps across the block's
threads (pieces of 16 chunks past 128 steps; one chunk of 64 channels a
block at S <= 8), the grid, the shared memory of a block, the blocks an
SM and the waves. Every (b, t, r) must belong to
exactly one thread, and the blocks an SM the plan reports must fit the
H100's 227 KB of shared memory.

``ref.rglru_scan_chunked_ref`` is a plain emulation of the kernel's
order of operations: each chunk folded into its map h -> A h + Bc, h0
carried through the maps in chunk order, each chunk walked again from
its carry. It is held against the reference's associative-scan oracle
and its Pallas kernel in interpret mode on the same numpy-seeded
inputs, S not a multiple of the chunk, one chunk, pieces, and a nonzero
h0 throughout: float32 within atol 2e-5, rtol 1e-5 (the same products
associated in another order), bfloat16 within the reference kernel-test
bar of ``test_torch_rglru_scan.TOL``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan.ops import rglru_scan as ref_kernel
from repro.kernels.rglru_scan.ref import rglru_scan_ref as ref_oracle
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.kernels.rglru_scan import (rglru_scan_chunked_ref,
                                            rglru_scan_ref)

torch.set_num_threads(1)
TOL = {"float32": (2e-5, 1e-5), "bfloat16": (5 * 2e-2, 3e-2)}
STEPS = [1, 32, 37, 512, 2048]
H100_SMEM = 227 * 1024


@pytest.mark.parametrize("R", [2560, 50])
@pytest.mark.parametrize("S", STEPS)
def test_every_element_has_one_thread(S, R):
    """Blocks tile the channels; thread (j, c) of block (x, b) takes
    channel j of the tile and chunk c of every piece: each (b, t, r)
    exactly once."""
    B = 2
    plan = scan_ops.scan_plan(B, S, R)
    assert plan.grid[1] == B
    assert plan.threads == plan.block_channels * plan.chunks
    seen = np.zeros((S, R), np.int32)            # one batch row's cells
    for x in range(plan.grid[0]):
        chans = list(plan.channels(x))
        assert len(chans) <= plan.block_channels
        for piece in range(plan.pieces):
            for c in range(plan.chunks):
                steps = plan.steps(piece, c)
                assert len(steps) <= plan.chunk
                seen[steps.start:steps.stop, chans[0]:chans[-1] + 1] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("S", STEPS)
def test_shared_memory_fits_the_blocks_an_sm(S, dtype):
    plan = scan_ops.scan_plan(2, S, 2560, dtype)
    assert plan.smem_bytes == scan_ops.smem_bytes() == 4 * (3 * 16 * 16 + 16)
    assert plan.blocks_per_sm >= 1
    assert plan.smem_bytes * plan.blocks_per_sm <= H100_SMEM
    assert plan.threads * plan.blocks_per_sm <= 2048
    assert plan.threads * plan.blocks_per_sm * scan_ops.REGISTERS <= 65536


@pytest.mark.parametrize("S, chunk, chunks, pieces, width", [
    (1, 1, 1, 1, 64),       # a decode step: one chunk, no carry
    (8, 8, 1, 1, 64),
    (9, 8, 2, 1, 16),
    (32, 8, 4, 1, 16),      # split serving
    (37, 8, 5, 1, 16),      # a short last chunk
    (128, 8, 16, 1, 16),
    (129, 8, 16, 2, 16),    # a second piece of one step
    (512, 8, 16, 4, 16),    # prefill
    (2048, 8, 16, 16, 16),  # RecurrentGemma's window
])
def test_chunk_rule(S, chunk, chunks, pieces, width):
    plan = scan_ops.scan_plan(1, S, 64)
    assert (plan.chunk, plan.chunks, plan.pieces) == (chunk, chunks, pieces)
    assert plan.block_channels == width


def test_the_prefill_shape_is_one_wave_of_three_blocks_an_sm():
    """RecurrentGemma-2B: B 2, R 2560 -> 160 channel tiles, 320 blocks
    of 256 threads, within three blocks on each of an H100's 132 SMs;
    its decode step 80 blocks of 64."""
    plan = scan_ops.scan_plan(2, 512, 2560)
    assert plan.grid == (160, 2) and plan.threads == 256
    assert plan.pieces == 4
    step = scan_ops.scan_plan(2, 1, 2560)
    assert step.grid == (40, 2) and step.threads == 64 and step.waves == 1
    assert plan.blocks_per_sm == 3 and plan.blocks == 320 <= 3 * 132
    assert plan.waves == 1


def test_the_planner_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError, match="instance"):
        scan_ops.scan_plan(1, 4, 8, torch.float16)


def _inputs(B, S, R, dt, seed):
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


CASES = [
    # (B, S, R, chunks, chunk, dtype); chunks None: the kernel's plan
    (2, 37, 50, None, None, "float32"),     # a short last chunk, ragged R
    (2, 64, 32, None, None, "bfloat16"),
    (1, 300, 24, None, None, "float32"),    # three pieces, the last short
    (2, 48, 16, 1, None, "float32"),        # one chunk: the plain walk
    (2, 33, 16, 4, None, "float32"),        # chunks of 9, the last of 6
    (1, 40, 16, 3, 4, "float32"),           # pieces of 3 chunks of 4
    (3, 1, 40, None, None, "float32"),      # a decode step
]


@pytest.mark.parametrize("against", ["jnp_oracle", "pallas_interpret"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_chunked_emulation_matches_reference(case, against):
    B, S, R, chunks, chunk, dt = case
    jx, tx = _inputs(B, S, R, dt, seed=S + R)
    if against == "jnp_oracle":
        want_hs, want_h = ref_oracle(*jx)
    else:
        want_hs, want_h = ref_kernel(*jx, chunk=16, block_r=16,
                                     interpret=True)
    hs, h_last = rglru_scan_chunked_ref(*tx, chunks=chunks, chunk=chunk)
    assert hs.shape == (B, S, R) and hs.dtype == tx[0].dtype
    assert h_last.shape == (B, R) and h_last.dtype == torch.float32
    atol, rtol = TOL[dt]
    np.testing.assert_allclose(_f32(hs), _f32(want_hs), atol=atol, rtol=rtol)
    np.testing.assert_allclose(_f32(h_last), _f32(want_h), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_h_last_is_the_last_h_of_walk_2(case):
    """The kernel writes h_last from the h that walk 2 rounds into
    hs[:, -1]: the two agree exactly, in float32 and after rounding."""
    B, S, R, chunks, chunk, dt = case
    _, tx = _inputs(B, S, R, dt, seed=S + R + 1)
    hs, h_last = rglru_scan_chunked_ref(*tx, chunks=chunks, chunk=chunk)
    f32_hs, f32_h = rglru_scan_chunked_ref(tx[0].float(), tx[1].float(),
                                           tx[2], chunks=chunks, chunk=chunk)
    assert torch.equal(f32_h, f32_hs[:, -1])
    assert torch.equal(hs[:, -1], h_last.to(hs.dtype))


def test_one_chunk_walks_in_the_plain_versions_order():
    """With one chunk there is no carry: walk 2 from h0 is the plain
    version's loop, each step's multiply-add fused."""
    _, (a, b, h0) = _inputs(2, 23, 12, "float32", seed=2)
    hs, h_last = rglru_scan_chunked_ref(a, b, h0, chunks=1)
    h = h0.double()
    for t in range(23):
        h = (a[:, t].double() * h + b[:, t].double()).float().double()
        assert torch.equal(hs[:, t], h.float())
    assert torch.equal(h_last, h.float())
    want_hs, _ = rglru_scan_ref(a, b, h0)
    np.testing.assert_allclose(hs.numpy(), want_hs.numpy(), atol=2e-5,
                               rtol=1e-5)


def test_no_step_returns_h0():
    a = torch.zeros(2, 0, 8)
    h0 = torch.arange(16, dtype=torch.float32).view(2, 8)
    hs, h_last = rglru_scan_chunked_ref(a, a, h0)
    assert hs.shape == (2, 0, 8) and torch.equal(h_last, h0)
