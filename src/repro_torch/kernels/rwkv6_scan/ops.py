"""Public wrapper of the ``rwkv6_scan`` kernel. Counterpart of
``repro/kernels/rwkv6_scan/ops.py``.

For tensors on the CPU it returns the plain PyTorch version
(``ref.py``). For CUDA tensors it launches the hand-written kernel
(``kernel.py``) or raises: there is no fallback. Unlike the TPU wrapper
it pads nothing; the kernel walks any S and any head dim up to 256.
``s_out``, when given, receives the final state (it may be ``s0``
itself, so a recurrent state is updated in place: each block of the
kernel reads its tile of the state before it writes it).
``rwkv6_scan.launches`` counts the kernel's launches. ``scan_plan``
gives, from shapes alone, the kernel's instance, tiles, chunk, grid and
shared memory, as ``rwkv6_scan.cu`` chooses them.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.rwkv6_scan import kernel
from repro_torch.kernels.rwkv6_scan.kernel import MAX_HEAD_DIM
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

DTYPES = (torch.float32, torch.bfloat16)
COLS = 20                       # state columns a block
CHAINS = 32                     # 8 groups of rows, 4 chains each
THREADS = CHAINS * COLS // 4    # 160: a chain x 4 columns a thread
CHAIN_ROWS = (1, 2, 5, 8)       # the kernel's instances: rows a chain (L)
SMEM_LIMIT = 113 * 1024         # bytes a block, so that two fit an SM


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


def rwkv6_scan(r, k, v, logw, u, s0, s_out=None):
    """r, k, v, logw (B,S,H,hd) of one dtype; u (H,hd) float32; s0
    (B,H,hd,hd) float32 -> (o (B,S,H,hd) in r's dtype, s_last
    (B,H,hd,hd) float32). ``s_last`` is ``s_out`` when given."""
    if r.device.type == "cpu":
        o, s_last = rwkv6_scan_ref(r, k, v, logw, u, s0)
        if s_out is None:
            return o, s_last
        return o, s_out.copy_(s_last)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan runs on CUDA or the CPU, not "
                         f"{r.device}")
    _check(r, k, v, logw, u, s0, s_out)
    o = torch.empty(r.shape, dtype=r.dtype, device=r.device)
    s_last = (torch.empty(s0.shape, dtype=torch.float32, device=r.device)
              if s_out is None else s_out)
    kernel.launch(r, k, v, logw, u, s0, o, s_last)
    rwkv6_scan.launches += 1
    return o, s_last


rwkv6_scan.launches = 0
