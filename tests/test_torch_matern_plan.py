"""The CUDA posterior kernel's plan on the CPU.

``ops.posterior_plan`` decides, from shapes alone, what
``matern_posterior`` launches for the posterior of S x N candidates
under GPs of n points: the instance (NMAX, the smallest of 16/32/48/64
that holds n), threads a block (128, halved while the grid would leave
SMs of an H100 without a block), the grid and shared memory a block.
Held here at the (S, N, n) the main path launches (the batched grid at
n 16 and then at n 32, the sequential run and Qwen2-1.5B's serving run,
all at n 16 but the grid's second half) and at the ceiling rows: the
instance, the grid, the blocks an SM must hold for one wave, and the
waves at a given occupancy. Every candidate must have exactly one
thread, and a block's shared memory must stay within the 48 KB a block
holds without opting in. ``chip_smoke.py`` holds the built kernel's
registers, spills and blocks an SM to the plan on the card."""
import pytest

from repro_torch.kernels.matern_score import ops

MAIN_N = 64 * 64 + 37 + 45          # grid + VGG19 boundary + local slots
SERVE_N = 64 * 64 + 28 + 45         # Qwen2-1.5B's 28 split layers
H100_SMEM = 228 * 1024              # an SM's shared memory
BLOCK_SMEM_RESERVED = 1024          # the runtime's own, each block


@pytest.mark.parametrize("S, N, n, nmax, threads, grid, one_wave", [
    (16, MAIN_N, 16, 16, 128, (33, 16), 4),      # batched grid, n 16
    (6, MAIN_N, 32, 32, 128, (33, 6), 2),        # batched grid, n 32
    (1, MAIN_N, 16, 16, 32, (131, 1), 1),        # sequential run
    (1, SERVE_N, 16, 16, 32, (131, 1), 1),       # Qwen2-1.5B serving
    (16, MAIN_N, 32, 32, 128, (33, 16), 4),      # ceiling rows
    (16, MAIN_N, 48, 48, 128, (33, 16), 4),
    (16, MAIN_N, 64, 64, 128, (33, 16), 4),
    (256, MAIN_N, 64, 64, 128, (33, 256), 64),
    (3, 203, 5, 16, 32, (7, 3), 1),              # padded n, ragged N
    (3, 203, 37, 48, 32, (7, 3), 1),
])
def test_plan_at_the_main_path_and_the_ceiling(S, N, n, nmax, threads, grid,
                                               one_wave):
    plan = ops.posterior_plan(S, N, n)
    assert (plan.instance, plan.threads, plan.grid) == (nmax, threads, grid)
    assert plan.smem_bytes == ops.posterior_smem_bytes(nmax)
    assert plan.blocks == grid[0] * grid[1]
    assert plan.one_wave_blocks_per_sm == one_wave
    assert plan.waves(one_wave) == 1
    assert one_wave == 1 or plan.waves(one_wave - 1) == 2


def test_waves_at_an_occupancy():
    """S 256 at n 64: 8,448 blocks, four an SM (the built n-64 instance's
    occupancy at 128 threads on an H100) take 16 waves of 528."""
    plan = ops.posterior_plan(256, MAIN_N, 64)
    assert [plan.waves(b) for b in (1, 4, 64)] == [64, 16, 1]


@pytest.mark.parametrize("S, N", [(16, MAIN_N), (1, MAIN_N), (3, 203),
                                  (2, 64), (1, 1)])
def test_every_candidate_has_one_thread(S, N):
    plan = ops.posterior_plan(S, N, 32)
    seen = [0] * N
    for x in range(plan.grid[0]):
        cands = plan.candidates(x)
        assert len(cands) <= plan.threads
        for c in cands:
            seen[c] += 1
    assert seen == [1] * N


@pytest.mark.parametrize("nmax", ops.INSTANCES)
@pytest.mark.parametrize("S", [1, 2, 6, 16])
def test_blocks_an_sm_fit_the_sm(nmax, S):
    """Shared memory within 48 KB a block, and little enough that an SM
    holds the blocks one wave of S x 4,178 candidates needs: shared
    memory never bounds the occupancy the plan asks for."""
    smem = ops.posterior_smem_bytes(nmax)
    assert smem == 4 * (nmax * nmax + 6 * nmax) <= 48 * 1024
    need = ops.posterior_plan(S, MAIN_N, nmax).one_wave_blocks_per_sm
    assert need * (smem + BLOCK_SMEM_RESERVED) <= H100_SMEM


def test_instances_and_threads():
    assert [ops.instance(n) for n in (0, 1, 16, 17, 32, 33, 48, 49, 64)] == [
        16, 16, 16, 32, 32, 48, 48, 64, 64]
    with pytest.raises(ValueError):
        ops.instance(65)
    # S 2 at N 4,178: 66 blocks of 64 a scenario fill the 132 SMs
    assert [ops.posterior_threads(S, MAIN_N) for S in (1, 2, 4, 16)] == [
        32, 64, 128, 128]
