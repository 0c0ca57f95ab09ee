"""Public wrapper of the ``rglru_scan`` kernel. Counterpart of
``repro/kernels/rglru_scan/ops.py``.

For tensors on the CPU it returns the plain PyTorch version
(``ref.py``). For CUDA tensors it launches the hand-written kernel
(``kernel.py``) or raises: there is no fallback. Unlike the TPU wrapper
it pads nothing; the kernel walks any S and masks ragged R itself.
``h_out``, when given, receives ``h_last`` (it may be ``h0`` itself, so
a recurrent state is updated in place). On CUDA tensors that autograd
records (grad enabled and an input requires grad) it goes through
``RGLRUScan``, a ``torch.autograd.Function`` whose backward is the
backward kernel (``rglru_scan_bwd``, float32 only: such a call in
bfloat16 raises ``TypeError``, one with ``h_out``, a serving path,
``ValueError``); CPU tensors keep autograd through the plain version.
``rglru_scan.launches`` and ``rglru_scan_bwd.launches`` count the
kernels' launches. ``scan_plan``
gives, from shapes alone, the kernel's chunks, pieces, grid, shared
memory, blocks an SM and waves, as ``rglru_scan.cu`` chooses them.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.autograd import needs_backward
from repro_torch.kernels.rglru_scan import kernel
from repro_torch.kernels.rglru_scan.ref import (rglru_scan_bwd_ref,
                                               rglru_scan_ref)

DTYPES = (torch.float32, torch.bfloat16)
CHANNELS = 16               # channels a block with more than one chunk
ONE_CHUNK_CHANNELS = 64     # channels a block with one chunk (S <= 8)
MAX_CHUNKS = 16             # chunks a channel in one piece
CHUNK_STEPS = 8             # steps a chunk (L) past S = 1
REGISTERS = 80              # a thread at most: __launch_bounds__(256, 3)
SMEM_LIMIT = 227 * 1024     # shared memory an H100 SM gives its blocks
SMS = 132                   # an H100 SXM's SMs


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """One launch. Block (x, b) owns channels ``channels(x)`` of batch
    row b; its thread (j, c) owns the j-th of them and chunk c of every
    piece of ``chunks x chunk`` steps: ``steps(piece, c)``. Pieces run
    one after the other, the next one's loads issued before this one's
    walks; with one chunk there is no walk 1, no carry and no barrier."""
    B: int
    S: int
    R: int
    chunk: int                  # steps a chunk (L)
    chunks: int                 # chunks a piece (C)
    pieces: int
    block_channels: int
    grid: tuple                 # (channel tiles, B)
    threads: int                # a block: block_channels x chunks
    smem_bytes: int
    blocks_per_sm: int
    waves: int

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]

    def channels(self, x: int) -> range:
        w = self.block_channels
        return range(x * w, min((x + 1) * w, self.R))

    def steps(self, piece: int, c: int) -> range:
        t0 = (piece * self.chunks + c) * self.chunk
        return range(min(t0, self.S), min(t0 + self.chunk, self.S))


def smem_bytes() -> int:
    """Shared memory of a block: each chunk's A and Bc and its carry,
    for MAX_CHUNKS chunks of CHANNELS channels, and the h handed from
    one piece to the next, all float32."""
    return 4 * (3 * MAX_CHUNKS * CHANNELS + CHANNELS)


def scan_plan(B: int, S: int, R: int, dtype=torch.float32) -> ScanPlan:
    """What ``rglru_scan.cu`` launches for a (B, S, R) scan: chunks of
    CHUNK_STEPS steps (one step at S = 1), ceil(S / L) of them a piece
    up to MAX_CHUNKS. The dtype changes neither; it is taken for the
    symmetry with the built kernel's query."""
    if dtype not in DTYPES:
        raise TypeError(f"rglru_scan: no instance for {dtype}")
    L = 1 if S <= 1 else CHUNK_STEPS
    C = min(MAX_CHUNKS, max(1, -(-S // L)))
    w = ONE_CHUNK_CHANNELS if C == 1 else CHANNELS
    threads = w * C
    warps = -(-threads // 32)
    per_sm = min(32, 64 // warps, 65536 // (32 * warps * REGISTERS),
                 SMEM_LIMIT // smem_bytes())
    grid = (-(-R // w), B)
    return ScanPlan(B=B, S=S, R=R, chunk=L, chunks=C,
                    pieces=-(-S // (C * L)), block_channels=w, grid=grid,
                    threads=threads, smem_bytes=smem_bytes(),
                    blocks_per_sm=per_sm,
                    waves=-(-grid[0] * grid[1] // (per_sm * SMS)))


def _check(a, b, h0, h_out):
    for name, t in dict(b=b, h0=h0, h_out=h_out).items():
        if t is not None and t.device != a.device:
            raise ValueError(f"rglru_scan: {name} is on {t.device}, a on "
                             f"{a.device}")
    if a.dtype != b.dtype or a.dtype not in DTYPES:
        raise TypeError("rglru_scan: a and b must share one dtype, float32 "
                        f"or bfloat16; got {a.dtype}, {b.dtype}")
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must be one (B,S,R) shape")
    if a.stride(-1) != 1 or b.stride(-1) != 1:
        raise ValueError("rglru_scan: a and b must have a contiguous "
                         "channel dim")
    B, _, R = a.shape
    for name, t in dict(h0=h0, h_out=h_out).items():
        if t is None:
            continue
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"rglru_scan: {name} must be contiguous float32")
        if tuple(t.shape) != (B, R):
            raise ValueError(f"rglru_scan: {name} {tuple(t.shape)} is not "
                             f"(B,R) = {(B, R)}")
    if B > 65535:
        raise ValueError("rglru_scan: batch must be at most 65535")


def _check_bwd(a, h0, hs, dhs, dh_last):
    B, S, R = a.shape
    if a.dtype != torch.float32:
        raise TypeError(f"rglru_scan_bwd: the backward kernel is float32 "
                        f"only, not {a.dtype}")
    for name, t, shape in (("h0", h0, (B, R)), ("hs", hs, (B, S, R)),
                           ("dhs", dhs, (B, S, R)),
                           ("dh_last", dh_last, (B, R))):
        if t is None:
            continue
        if (t.device != a.device or t.dtype != torch.float32
                or tuple(t.shape) != shape):
            raise ValueError(f"rglru_scan_bwd: {name} must be float32 "
                             f"{shape} on {a.device}")
        if not (t.is_contiguous() or name == "dhs"):
            raise ValueError(f"rglru_scan_bwd: {name} must be contiguous")
    if a.ndim != 3 or a.stride(-1) != 1:
        raise ValueError("rglru_scan_bwd: a must be (B,S,R) with a "
                         "contiguous channel dim")
    if B > 65535:
        raise ValueError("rglru_scan: batch must be at most 65535")


def rglru_scan_bwd(a, h0, hs, dhs, dh_last=None):
    """(da, db, dh0) of ``rglru_scan(a, b, h0)`` = (hs, h_last) at the
    cotangents (dhs, dh_last); ``dh_last`` None counts as zero. ``hs`` is
    the forward's output. CPU tensors get the plain reverse loop
    (``rglru_scan_bwd_ref``), CUDA tensors the float32 kernel. ``dhs``
    may be strided: it is made contiguous where its channel dim is
    not."""
    if a.device.type == "cpu":
        return rglru_scan_bwd_ref(a, h0, hs, dhs, dh_last)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan_bwd runs on CUDA or the CPU, not "
                         f"{a.device}")
    if dhs.stride(-1) != 1:
        dhs = dhs.contiguous()
    _check_bwd(a, h0, hs, dhs, dh_last)
    da = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    db = torch.empty_like(da)
    dh0 = torch.empty(h0.shape, dtype=torch.float32, device=a.device)
    kernel.launch_bwd(a, h0, hs, dhs, dh_last, da, db, dh0)
    rglru_scan_bwd.launches += 1
    return da, db, dh0


class RGLRUScan(torch.autograd.Function):
    """The scan under autograd: the forward keeps a, h0 and hs; the
    backward is ``rglru_scan_bwd``, with a missing cotangent as zero. On
    CPU tensors both are the plain versions."""

    @staticmethod
    def forward(ctx, a, b, h0):
        hs, h_last = rglru_scan(a, b, h0)
        ctx.save_for_backward(a, h0, hs)
        ctx.set_materialize_grads(False)
        return hs, h_last

    @staticmethod
    def backward(ctx, dhs, dh_last):
        a, h0, hs = ctx.saved_tensors
        if dhs is None:
            dhs = torch.zeros_like(hs)
        da, db, dh0 = rglru_scan_bwd(a, h0, hs, dhs, dh_last)
        return da, db, dh0 if ctx.needs_input_grad[2] else None


def rglru_scan(a, b, h0, h_out=None):
    """a, b (B,S,R) of one dtype; h0 (B,R) float32 -> (hs (B,S,R) in a's
    dtype, h_last (B,R) float32). ``h_last`` is ``h_out`` when given."""
    if a.device.type == "cpu":
        hs, h_last = rglru_scan_ref(a, b, h0)
        if h_out is None:
            return hs, h_last
        return hs, h_out.copy_(h_last)
    recorded = needs_backward(a, b, h0)
    if recorded:
        if h_out is not None:
            raise ValueError("rglru_scan: h_out writes a serving state in "
                             "place; a call that autograd records takes "
                             "none")
        if a.dtype != torch.float32 or b.dtype != torch.float32:
            raise TypeError(f"rglru_scan: the backward kernel is float32 "
                            f"only; autograd records a {a.dtype} call")
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on CUDA or the CPU, not "
                         f"{a.device}")
    if recorded:
        return RGLRUScan.apply(a, b, h0)
    _check(a, b, h0, h_out)
    hs = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    h_last = (torch.empty(h0.shape, dtype=torch.float32, device=a.device)
              if h_out is None else h_out)
    kernel.launch(a, b, h0, hs, h_last)
    rglru_scan.launches += 1
    return hs, h_last


rglru_scan.launches = 0
rglru_scan_bwd.launches = 0
