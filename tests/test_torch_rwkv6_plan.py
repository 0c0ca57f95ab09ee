"""The CUDA ``rwkv6_scan``'s plan and order of operations, on the CPU.

``ops.scan_plan`` gives, from shapes alone, what ``rwkv6_scan.cu``
launches: the instance (rows a chain), the 20-column tiles, the chunk,
the grid and the shared memory of a block. Every state element of every
(b, h) must belong to exactly one thread, and a block must leave room
for a second one on an SM (113 KB of the H100's 227).

``ref.rwkv6_scan_tiled_ref`` is a plain emulation of the kernel's order
of operations: 8 groups of rows, each as four interleaved chains added
(c0 + c1) + (c2 + c3), the group sums added in group order per chunk of
steps, S not a multiple of the chunk. It is held against the reference's
sequential oracle and its Pallas kernel in interpret mode on the same
numpy-seeded inputs: float32 within atol = rtol = 1e-5 (the orders of the
sums differ), bfloat16 within the reference kernel-test bar of
``test_torch_rwkv6_scan.TOL``.

``ops.bwd_plan`` does the same for the backward's row kernel
(``rwkv6_scan_bwd.cu``): its instance (columns a lane), rows a block,
rows a thread, threads (the compute threads and a copy warp), grid and
shared memory. For every hd in 1..256 its lanes' columns must cover hd
with the smallest instance, its blocks' rows cover hd once, and a
block's shared memory fit the H100's 227 KB, with room for two blocks
an SM. The sizing it shares with the kernel reaches nvcc from
``kernel.py`` alone."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_scan.ops import rwkv6_scan as ref_kernel
from repro.kernels.rwkv6_scan.ref import rwkv6_scan_ref as ref_oracle
from repro_torch.kernels.rwkv6_scan import kernel as scan_kernel
from repro_torch.kernels.rwkv6_scan import ops as scan_ops
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_tiled_ref

torch.set_num_threads(1)
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (5 * 2e-2, 3e-2)}
HEAD_DIMS = [8, 16, 32, 100, 160, 256]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_every_state_element_has_one_thread(hd):
    """Tiles split the columns; within a block, thread (chain, quad)
    holds its chain's rows for its four columns: each (row, column) of
    the (hd, hd) state exactly once."""
    plan = scan_ops.scan_plan(2, 3, hd, 40)
    cols = [c for tile in range(plan.col_tiles) for c in plan.columns(tile)]
    assert sorted(cols) == list(range(hd))
    seen = np.zeros((hd, hd), int)
    for tile in range(plan.col_tiles):
        for t in range(scan_ops.THREADS):
            rows = plan.thread_rows(t)
            tile_cols = plan.thread_columns(tile, t)
            assert set(tile_cols) <= set(plan.columns(tile))
            for row in rows:
                for col in tile_cols:
                    seen[row, col] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_a_thread_walks_one_chain_of_its_group(hd):
    """Rows 4q + e of group g, q in order: the chain the kernel sums
    with fused multiply-adds."""
    plan = scan_ops.scan_plan(1, 1, hd, 1)
    for t in range(scan_ops.THREADS):
        rows = plan.thread_rows(t)
        assert rows == sorted(rows) and len(rows) <= plan.chain
        if rows:
            g, e = rows[0] // (4 * plan.chain), rows[0] % 4
            assert rows == [g * 4 * plan.chain + 4 * q + e
                            for q in range(len(rows))]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_two_blocks_fit_an_sm(hd, dtype):
    plan = scan_ops.scan_plan(2, 16, hd, 512, dtype)
    assert plan.smem_bytes <= scan_ops.SMEM_LIMIT == 113 * 1024
    assert plan.smem_bytes == scan_ops.smem_bytes(plan.chain, plan.chunk,
                                                  dtype)
    assert plan.chunk == (16 if hd <= 160 else 8)
    assert 32 * plan.chain >= hd
    assert plan.n_chunks == -(-512 // plan.chunk)


def test_the_model_shape_is_one_wave_of_two_blocks_an_sm():
    """RWKV6-3B: B 2, H 16, hd 160 -> 8 tiles of 20 columns, 256 blocks
    of 160 threads, within two blocks on each of an H100's 132 SMs."""
    plan = scan_ops.scan_plan(2, 16, 160, 512)
    assert (plan.chain, plan.col_tiles, plan.grid) == (5, 8, (8, 16, 2))
    assert plan.blocks == 256 <= 2 * 132
    assert scan_ops.THREADS == 160


def test_the_planner_rejects_what_the_kernel_does_not_take():
    for hd in (0, 257):
        with pytest.raises(ValueError, match="head dim"):
            scan_ops.scan_plan(1, 1, hd, 4)


def _inputs(B, S, H, hd, dt, seed):
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
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 100, 160])
@pytest.mark.parametrize("S", [1, 17, 33])
def test_tiled_emulation_matches_reference(S, hd, dt, against):
    B, H = 1, 2
    jx, tx = _inputs(B, S, H, hd, dt, seed=S + hd)
    if against == "jnp_oracle":
        want_o, want_s = ref_oracle(*jx)
    else:
        want_o, want_s = ref_kernel(*jx, chunk=8, interpret=True)
    plan = scan_ops.scan_plan(B, H, hd, S, getattr(torch, dt))
    o, s_last = rwkv6_scan_tiled_ref(*tx, chain=plan.chain,
                                     chunk=plan.chunk)
    assert o.shape == (B, S, H, hd) and o.dtype == tx[0].dtype
    assert s_last.shape == (B, H, hd, hd) and s_last.dtype == torch.float32
    atol, rtol = TOL[dt]
    np.testing.assert_allclose(_f32(o), _f32(want_o), atol=atol, rtol=rtol)
    np.testing.assert_allclose(_f32(s_last), _f32(want_s), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("chunk", [1, 4, 16])
def test_tiled_emulation_does_not_depend_on_the_chunk(chunk):
    """The sums are per step: the chunk decides only when they are
    taken, so any chunk gives the same result bit for bit."""
    _, tx = _inputs(2, 19, 2, 40, "float32", seed=4)
    want = rwkv6_scan_tiled_ref(*tx, chain=2, chunk=16)
    got = rwkv6_scan_tiled_ref(*tx, chain=2, chunk=chunk)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


H100_SMEM_BLOCK = 227 * 1024            # bytes a block may take
WIDTHS = (32, 64, 160, 256)             # the row kernel's instances


def test_bwd_plan_covers_every_head_dim():
    for hd in range(1, 257):
        plan = scan_ops.bwd_plan(2, 16, hd, 512)
        width = plan.lanes * plan.columns
        assert width == min(w for w in WIDTHS if w >= hd), hd
        assert (plan.lanes, plan.rows_per_thread) == (16, 2)
        assert plan.grid[0] * plan.rows >= hd > (plan.grid[0] - 1) * plan.rows
        assert plan.rows % (32 * plan.rows_per_thread // plan.lanes) == 0
        assert plan.threads % 32 == 0 and plan.threads <= 1024
        assert plan.smem_bytes <= scan_ops.SMEM_LIMIT < H100_SMEM_BLOCK
        assert plan.smem_bytes == scan_ops.bwd_smem_bytes(plan.columns,
                                                          plan.rows)
        assert 1 <= plan.reg_states <= scan_ops.CKPT_STEPS - 1
        assert plan.spans == -(-512 // scan_ops.CKPT_STEPS)


@pytest.mark.parametrize("hd", [1, 2, 3, 16, 17, 20, 31, 32, 33, 37, 63,
                                64, 65, 100, 128, 159, 160, 161, 200, 256])
def test_bwd_plan_gives_each_state_element_one_thread(hd):
    """Block x's compute thread t holds rows thread_rows(x, t) at the
    columns of its lane: every (row, column) of the (hd, hd) state
    exactly once; the last warp copies and holds none."""
    plan = scan_ops.bwd_plan(1, 1, hd, 9)
    seen = np.zeros((hd, hd), int)
    for x in range(plan.grid[0]):
        rows = []
        for t in range(plan.threads - 32):
            held = plan.thread_rows(x, t)
            rows += held
            cols = list(plan.lane_cols(t % plan.lanes))
            for row in held:
                seen[row, cols] += 1
        assert sorted(set(rows)) == list(plan.rows_of(x))
    assert (seen == 1).all()


def test_bwd_plan_at_the_training_shape():
    """RWKV6-3B's training microbatch: 16 lanes of 10 columns for two
    rows a thread, 20 rows a block of 160 compute threads and a copy
    warp, 256 blocks: one wave of two blocks an SM on an H100's 132."""
    plan = scan_ops.bwd_plan(2, 16, 160, 512)
    assert (plan.lanes, plan.columns, plan.rows_per_thread) == (16, 10, 2)
    assert (plan.rows, plan.threads, plan.grid) == (20, 192, (8, 16, 2))
    assert plan.blocks == 256 <= 2 * 132
    assert plan.reg_states == 2 and plan.smem_bytes == 114000


def test_bwd_plan_and_the_build_share_one_sizing():
    """The constants the plan sizes blocks by are the ones ``kernel.py``
    passes to nvcc: the shared-memory limit to both sources, the row
    kernel's threads and register budget to its own, the checkpoint
    interval to both."""
    both = {f"-DRWKV6_CKPT_STEPS={scan_ops.CKPT_STEPS}",
            f"-DRWKV6_SMEM_LIMIT={scan_ops.SMEM_LIMIT}"}
    rows = {f"-DRWKV6_BWD_MAX_THREADS={scan_ops.BWD_MAX_THREADS}",
            f"-DRWKV6_BWD_REG_FLOATS={scan_ops.BWD_REG_FLOATS}"}
    fwd = {f for f in scan_kernel.LIB.flags if f.startswith("-DRWKV6_")}
    bwd = {f for f in scan_kernel.BWD_LIB.flags if f.startswith("-DRWKV6_")}
    assert fwd == both and bwd == both | rows
    plan = scan_ops.bwd_plan(2, 16, 160, 512)
    assert plan.threads - 32 <= scan_ops.BWD_MAX_THREADS
    assert (plan.reg_states * plan.columns * plan.rows_per_thread
            <= scan_ops.BWD_REG_FLOATS)


def test_bwd_plan_rejects_what_the_kernel_does_not_take():
    for hd in (0, 257):
        with pytest.raises(ValueError, match="head dim"):
            scan_ops.bwd_plan(1, 1, hd, 4)
