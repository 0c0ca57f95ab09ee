"""Public wrapper of the ``rwkv6_scan`` kernel. Counterpart of
``repro/kernels/rwkv6_scan/ops.py``.

For tensors on the CPU it returns the plain PyTorch version
(``ref.py``). For CUDA tensors it launches the hand-written kernel
(``kernel.py``) or raises: there is no fallback. Unlike the TPU wrapper
it pads nothing; the kernel walks any S and any head dim up to 256.
``s_out``, when given, receives the final state (it may be ``s0``
itself, so a recurrent state is updated in place: each block of the
kernel reads its tile of the state before it writes it).

On CUDA tensors that autograd records (grad enabled and an input
requires grad) it goes through ``RWKV6Scan``, a
``torch.autograd.Function`` whose forward also saves the state before
every ``CKPT_STEPS``-th step (``rwkv6_scan_fwd``) and whose backward is
the backward kernels (``rwkv6_scan_bwd``, float32 only: such a call in
bfloat16 raises ``TypeError``, one with ``s_out``, a serving path,
``ValueError``); CPU tensors keep autograd through the plain version.
``rwkv6_scan.launches`` and ``rwkv6_scan_bwd.launches`` count the
launches (a backward launch is three CUDA kernels: dv and ds0, the rows,
du's batch sum). ``scan_plan`` gives, from shapes alone, the kernel's
instance, tiles, chunk, grid and shared memory, as ``rwkv6_scan.cu``
chooses them; ``bwd_plan`` the same for the backward's row kernel
(``rwkv6_scan_bwd.cu``: rows of a block, lanes a row, each span of
``CKPT_STEPS`` steps walked once from its saved state).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.autograd import needs_backward
from repro_torch.kernels.rwkv6_scan import kernel
from repro_torch.kernels.rwkv6_scan.kernel import (BWD_MAX_THREADS,
                                                  BWD_REG_FLOATS,
                                                  MAX_HEAD_DIM, SMEM_LIMIT)
from repro_torch.kernels.rwkv6_scan.ref import (CKPT_STEPS, LANES,
                                               lane_columns,
                                               rwkv6_checkpoints_ref,
                                               rwkv6_scan_bwd_ref,
                                               rwkv6_scan_ref)

DTYPES = (torch.float32, torch.bfloat16)
COLS = 20                       # state columns a block
CHAINS = 32                     # 8 groups of rows, 4 chains each
THREADS = CHAINS * COLS // 4    # 160: a chain x 4 columns a thread
CHAIN_ROWS = (1, 2, 5, 8)       # the kernel's instances: rows a chain (L)


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """One launch of the kernel. Block (tile, h, b) owns state columns
    ``columns(tile)`` of head h, batch row b. The rows form 8 groups of
    ``4 chain`` rows; row 4q + e of group g feeds chain e. Thread t of a
    block holds one chain's rows ``thread_rows(t)`` for four columns
    ``thread_columns(tile, t)``. Steps are staged ``chunk`` at a
    time."""
    hd: int
    chain: int                  # rows a chain (L): a thread's rows
    col_tiles: int
    chunk: int
    n_chunks: int
    grid: tuple                 # (col_tiles, H, B)
    smem_bytes: int

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    def columns(self, tile: int) -> range:
        return range(tile * COLS, min((tile + 1) * COLS, self.hd))

    def thread_rows(self, t: int) -> list:
        """In the order the thread's chain takes them."""
        g, e = (t // 4) // (COLS // 4), t % 4
        row0 = g * 4 * self.chain + e
        return [row for q in range(self.chain)
                if (row := row0 + 4 * q) < self.hd]

    def thread_columns(self, tile: int, t: int) -> list:
        col0 = tile * COLS + 4 * ((t // 4) % (COLS // 4))
        return [c for c in range(col0, col0 + 4) if c < self.hd]


def smem_bytes(chain: int, chunk: int, dtype) -> int:
    """Shared memory of one block: the double-buffered ring of r, k, logw
    rows and v columns in the inputs' dtype, for bf16 r, k and exp(logw)
    widened to float32, the chain sums (33 rows of COLS a step, one of
    them padding), r . (u k) and u."""
    esize = torch.tensor([], dtype=dtype).element_size()
    rows = 32 * chain
    work = 0 if dtype == torch.float32 else 3 * chunk * rows * 4
    return (2 * chunk * (3 * rows + COLS) * esize + work
            + chunk * (CHAINS + 1) * COLS * 4 + chunk * 4 + rows * 4)


def scan_plan(B: int, H: int, hd: int, S: int,
              dtype=torch.float32) -> ScanPlan:
    """The smallest instance whose 8 groups of 4 L rows cover hd, and
    chunks of 16 steps, or 8 where 16 would not leave room for two
    blocks an SM."""
    if not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"rwkv6_scan: head dim {hd} is not in 1.."
                         f"{MAX_HEAD_DIM}")
    chain = next(n for n in CHAIN_ROWS if 32 * n >= hd)
    chunk = 16 if smem_bytes(chain, 16, dtype) <= SMEM_LIMIT else 8
    tiles = -(-hd // COLS)
    return ScanPlan(hd=hd, chain=chain, col_tiles=tiles, chunk=chunk,
                    n_chunks=-(-S // chunk), grid=(tiles, H, B),
                    smem_bytes=smem_bytes(chain, chunk, dtype))


BWD_ROWS_PER_THREAD = 2         # rows a thread of the row kernel


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """One launch of the backward's row kernel. Block (x, h, b) owns rows
    ``rows_of(x)`` of head h, batch row b. ``lanes`` (``LANES``) lanes
    share a row, lane l holding its ``columns`` columns ``lane_cols(l)``,
    for ``rows_per_thread`` consecutive rows. Each of ``spans`` spans of
    ``CKPT_STEPS`` steps is walked once from its saved state: the last
    ``reg_states`` states before its steps stay in registers, those
    between the first and them in a shared-memory stash."""
    hd: int
    lanes: int
    rows_per_thread: int
    columns: int                # a lane's columns (C)
    rows: int                   # rows a block (R)
    reg_states: int
    grid: tuple                 # (row blocks, H, B)
    smem_bytes: int
    spans: int

    @property
    def threads(self) -> int:
        """The compute threads and the copy warp."""
        return self.rows // self.rows_per_thread * self.lanes + 32

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    def rows_of(self, x: int) -> range:
        return range(x * self.rows, min((x + 1) * self.rows, self.hd))

    def thread_rows(self, x: int, t: int) -> list:
        first = x * self.rows + t // self.lanes * self.rows_per_thread
        return [row for row in range(first, first + self.rows_per_thread)
                if row < self.hd]

    def lane_cols(self, lane: int) -> range:
        return range(lane * self.columns,
                     min((lane + 1) * self.columns, self.hd))


def bwd_reg_states(columns: int) -> int:
    """States of a span a thread keeps in registers."""
    return min(CKPT_STEPS - 1,
               BWD_REG_FLOATS // (columns * BWD_ROWS_PER_THREAD))


def bwd_smem_bytes(columns: int, rows: int) -> int:
    """Shared memory of one block of the row kernel: v and do rows of a
    span (two buffers), the saved state (two buffers) and the stash of
    the states kept neither there nor in registers (a row's padded width
    each), r, k and exp(logw) of the block's rows (two buffers), v . do
    a step (two buffers), the bulk copies' mbarrier (16 bytes)."""
    width, ck = LANES * columns, CKPT_STEPS
    stash = ck - 1 - bwd_reg_states(columns)
    return 4 * (4 * ck * width + (2 + stash) * rows * width + 6 * ck * rows
                + 2 * ck + 4)


def bwd_rows(columns: int) -> int:
    """Rows a block: the most, in whole warps and up to BWD_MAX_THREADS
    compute threads, that leave room for two blocks an SM."""
    step = 32 * BWD_ROWS_PER_THREAD // LANES
    rows = BWD_MAX_THREADS // LANES * BWD_ROWS_PER_THREAD
    while rows > step and bwd_smem_bytes(columns, rows) > SMEM_LIMIT:
        rows -= step
    return rows


def bwd_plan(B: int, H: int, hd: int, S: int) -> BwdPlan:
    """The row kernel's instance for hd (``ref.lane_columns``), its rows
    a block, grid and shared memory, as ``rwkv6_scan_bwd.cu`` chooses
    them."""
    if not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"rwkv6_scan_bwd: head dim {hd} is not in 1.."
                         f"{MAX_HEAD_DIM}")
    columns = lane_columns(hd)
    rows = bwd_rows(columns)
    return BwdPlan(hd=hd, lanes=LANES, rows_per_thread=BWD_ROWS_PER_THREAD,
                   columns=columns, rows=rows,
                   reg_states=bwd_reg_states(columns),
                   grid=(-(-hd // rows), H, B),
                   smem_bytes=bwd_smem_bytes(columns, rows),
                   spans=-(-S // CKPT_STEPS))


def _check(r, k, v, logw, u, s0, s_out):
    for name, t in dict(k=k, v=v, logw=logw, u=u, s0=s0,
                        s_out=s_out).items():
        if t is not None and t.device != r.device:
            raise ValueError(f"rwkv6_scan: {name} is on {t.device}, r on "
                             f"{r.device}")
    for name, t in dict(r=r, k=k, v=v, logw=logw).items():
        if t.dtype != r.dtype or t.dtype not in DTYPES:
            raise TypeError("rwkv6_scan: r, k, v and logw must share one "
                            "dtype, float32 or bfloat16; got "
                            f"{r.dtype}, {k.dtype}, {v.dtype}, {logw.dtype}")
        if t.ndim != 4 or t.shape != r.shape or t.stride(-1) != 1:
            raise ValueError(f"rwkv6_scan: {name} {tuple(t.shape)} must be "
                             f"r's (B,S,H,hd) {tuple(r.shape)} with a "
                             "contiguous head dim")
    B, _, H, hd = r.shape
    want = dict(u=(H, hd), s0=(B, H, hd, hd), s_out=(B, H, hd, hd))
    for name, t in dict(u=u, s0=s0, s_out=s_out).items():
        if t is None:
            continue
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"rwkv6_scan: {name} must be contiguous float32")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"rwkv6_scan: {name} {tuple(t.shape)} is not "
                             f"{want[name]}")
    if not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"rwkv6_scan: head dim {hd} is not in 1.."
                         f"{MAX_HEAD_DIM}")
    if B > 65535 or H > 65535:
        raise ValueError("rwkv6_scan: batch and heads must each be at most "
                         "65535")


def _device(r, what):
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CUDA or the CPU, not {r.device}")


def rwkv6_scan_fwd(r, k, v, logw, u, s0):
    """The forward with the states the backward needs: (o, s_last,
    ckpt), ckpt (B, ceil(S / CKPT_STEPS), H, hd, hd) float32 the state
    before steps 0, CKPT_STEPS, ... (the plain version's on CPU
    tensors). o and s_last are the forward's without them, bit for
    bit. The kernel that saves the states is float32 only."""
    _device(r, "rwkv6_scan")
    if r.device.type == "cpu":
        return (*rwkv6_scan_ref(r, k, v, logw, u, s0),
                rwkv6_checkpoints_ref(r, k, v, logw, u, s0))
    if r.dtype != torch.float32:
        raise TypeError(f"rwkv6_scan_fwd: the kernel that saves the states "
                        f"is float32 only, not {r.dtype}")
    _check(r, k, v, logw, u, s0, None)
    B, S, H, hd = r.shape
    o = torch.empty(r.shape, dtype=r.dtype, device=r.device)
    s_last = torch.empty(s0.shape, dtype=torch.float32, device=r.device)
    ckpt = torch.empty(B, -(-S // CKPT_STEPS), H, hd, hd,
                       dtype=torch.float32, device=r.device)
    kernel.launch(r, k, v, logw, u, s0, o, s_last, ckpt)
    rwkv6_scan.launches += 1
    return o, s_last, ckpt


def rwkv6_scan_bwd(r, k, v, logw, u, s0, ckpt, do, ds_last=None):
    """(dr, dk, dv, dlogw, du, ds0) of ``rwkv6_scan`` at the cotangents
    (do, ds_last); ``ds_last`` None counts as zero. ``ckpt`` is
    ``rwkv6_scan_fwd``'s. CPU tensors get the plain reverse loop
    (``rwkv6_scan_bwd_ref``, from s0), CUDA tensors the float32 kernels
    (from ckpt, whose first state is s0). ``do`` may be strided: it is
    made contiguous, as are ds_last and inputs that are not."""
    _device(r, "rwkv6_scan_bwd")
    if r.device.type == "cpu":
        return rwkv6_scan_bwd_ref(r, k, v, logw, u, s0, do, ds_last)
    if r.dtype != torch.float32:
        raise TypeError(f"rwkv6_scan_bwd: the backward kernels are float32 "
                        f"only, not {r.dtype}")
    r, k, v, logw, do = (t.contiguous() for t in (r, k, v, logw, do))
    if ds_last is not None:
        ds_last = ds_last.contiguous()
    _check(r, k, v, logw, u, s0, ds_last)
    _check(do, k, v, logw, u, s0, None)
    B, S, H, hd = r.shape
    if (ckpt.dtype != torch.float32 or not ckpt.is_contiguous()
            or tuple(ckpt.shape) != (B, -(-S // CKPT_STEPS), H, hd, hd)
            or ckpt.device != r.device):
        raise ValueError("rwkv6_scan_bwd: ckpt must be rwkv6_scan_fwd's "
                         "contiguous float32 states")
    if ds_last is None:
        ds_last = torch.zeros(s0.shape, dtype=torch.float32, device=r.device)
    dr, dk, dv, dlogw = (torch.empty(r.shape, dtype=torch.float32,
                                     device=r.device) for _ in range(4))
    du_part = torch.empty(B, H, hd, dtype=torch.float32, device=r.device)
    du = torch.empty(H, hd, dtype=torch.float32, device=r.device)
    ds0 = torch.empty(s0.shape, dtype=torch.float32, device=r.device)
    kernel.launch_bwd(r, k, v, logw, u, ckpt, do, ds_last, dr, dk, dv, dlogw,
                      du_part, du, ds0)
    rwkv6_scan_bwd.launches += 1
    return dr, dk, dv, dlogw, du, ds0


class RWKV6Scan(torch.autograd.Function):
    """The scan under autograd: the forward keeps its inputs and the
    saved states (``rwkv6_scan_fwd``); the backward is
    ``rwkv6_scan_bwd``, with a missing cotangent as zero. On CPU tensors
    both are the plain versions."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, s0):
        o, s_last, ckpt = rwkv6_scan_fwd(r, k, v, logw, u, s0)
        ctx.save_for_backward(r, k, v, logw, u, s0, ckpt)
        ctx.set_materialize_grads(False)
        return o, s_last

    @staticmethod
    def backward(ctx, do, ds_last):
        r, k, v, logw, u, s0, ckpt = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(r)
        grads = rwkv6_scan_bwd(r, k, v, logw, u, s0, ckpt, do, ds_last)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def rwkv6_scan(r, k, v, logw, u, s0, s_out=None):
    """r, k, v, logw (B,S,H,hd) of one dtype; u (H,hd) float32; s0
    (B,H,hd,hd) float32 -> (o (B,S,H,hd) in r's dtype, s_last
    (B,H,hd,hd) float32). ``s_last`` is ``s_out`` when given."""
    if r.device.type == "cpu":
        o, s_last = rwkv6_scan_ref(r, k, v, logw, u, s0)
        if s_out is None:
            return o, s_last
        return o, s_out.copy_(s_last)
    recorded = needs_backward(r, k, v, logw, u, s0)
    if recorded:
        if s_out is not None:
            raise ValueError("rwkv6_scan: s_out writes a serving state in "
                             "place; a call that autograd records takes "
                             "none")
        if r.dtype != torch.float32:
            raise TypeError(f"rwkv6_scan: the backward kernels are float32 "
                            f"only; autograd records a {r.dtype} call")
    _device(r, "rwkv6_scan")
    if recorded:
        return RWKV6Scan.apply(r, k, v, logw, u, s0)
    _check(r, k, v, logw, u, s0, s_out)
    o = torch.empty(r.shape, dtype=r.dtype, device=r.device)
    s_last = (torch.empty(s0.shape, dtype=torch.float32, device=r.device)
              if s_out is None else s_out)
    kernel.launch(r, k, v, logw, u, s0, o, s_last)
    rwkv6_scan.launches += 1
    return o, s_last


rwkv6_scan.launches = 0
rwkv6_scan_bwd.launches = 0
