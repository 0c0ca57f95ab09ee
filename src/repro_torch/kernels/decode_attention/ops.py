"""Public wrapper of the ``decode_attention`` kernel. Counterpart of
``repro/kernels/decode_attention/ops.py``.

For tensors on the CPU it returns the plain PyTorch version
(``ref.py``). For CUDA tensors it launches the hand-written kernel
(``kernel.py``) or raises: there is no fallback. Unlike the TPU wrapper
it pads nothing; the kernel walks any cache length T itself, cut into
``decode_splits`` splits that run in parallel and that a second small
kernel merges. ``decode_attention.launches`` counts one launch per call.
With ``return_lse=True`` it also returns each row's natural log-sum-exp
of the scaled scores (B, Hq) in float32, which the merge kernel writes
in the same launch: the mesh path merges attention over a cache whose
slots are spread over ranks with it (``models/transformer.py``).

The launch is the operator ``repro_torch::decode_attention``
(``kernels/library.py``), whose fake implementation lets a fake trace
follow this path; its FLOP formula is 4 B Hq T hd (q k^T and p v over
every slot, filled or not).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import kernel
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.library import has_storage, kernel_op

DTYPES = (torch.float32, torch.bfloat16)
SMS = 132                 # streaming multiprocessors of an H100 SXM
MIN_SPLIT_SLOTS = kernel.SUB_TILE


def decode_splits(B: int, Hkv: int, T: int) -> tuple[int, int]:
    """(splits, slots per split) of a cache of T slots, from the shapes
    alone, so that a result never depends on the data: enough splits that
    the B x Hkv x splits blocks make about one wave over the card's SMs,
    but at least ``MIN_SPLIT_SLOTS`` slots each. The slots per split are
    a multiple of the kernel's 32-slot sub-tile; no split is empty."""
    most = max(1, T // MIN_SPLIT_SLOTS)
    want = -(-SMS // max(1, B * Hkv))
    n = min(most, want)
    sub = kernel.SUB_TILE
    chunk = -(-max(T, 1) // n)
    chunk = -(-chunk // sub) * sub
    return -(-max(T, 1) // chunk), chunk


def _aligned(t) -> bool:
    """16-byte base pointer and strides (but the head dim's) in 16-byte
    steps: what the kernel's 16-byte copies need."""
    step = 16 // t.element_size()
    return (t.data_ptr() % 16 == 0
            and all(s % step == 0 for s in t.stride()[:-1]))


def _check(q, k, v, kv_pos, q_pos, window):
    for name, t in dict(q=q, k=k, v=v, kv_pos=kv_pos, q_pos=q_pos).items():
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} is on {t.device}, "
                             f"q on {q.device}")
    for name, t in dict(q=q, k=k, v=v).items():
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError("decode_attention: q, k and v must share one "
                            "dtype, float32 or bfloat16; got "
                            f"{q.dtype}, {k.dtype}, {v.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"decode_attention: {name} must have a "
                             "contiguous head dim")
    for name, t in dict(kv_pos=kv_pos, q_pos=q_pos).items():
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"decode_attention: {name} must be contiguous "
                            "int32")
    if q.ndim != 3 or k.ndim != 4:
        raise ValueError("decode_attention: q must be (B,Hq,hd) and k/v "
                         f"(B,T,Hkv,hd), got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    B, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd
            or Hkv == 0 or Hq % Hkv or tuple(kv_pos.shape) != (B, T)
            or tuple(q_pos.shape) != (B,)):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)}, kv_pos "
                         f"{tuple(kv_pos.shape)} and q_pos "
                         f"{tuple(q_pos.shape)} do not fit")
    if hd % 8 or not 0 < hd <= 256:
        raise ValueError(f"decode_attention: head dim {hd} is not a "
                         "multiple of 8 up to 256")
    if (kernel.smem_bytes(hd, Hq // Hkv, q.element_size())
            > kernel.SMEM_LIMIT):
        raise ValueError(f"decode_attention: {Hq // Hkv} q heads per kv "
                         f"head at hd {hd} exceed a block's shared memory")
    if window < 0 or B * Hkv > 65535 or T < 1:
        raise ValueError("decode_attention: window must be >= 0, batch "
                         "times kv heads at most 65535, the cache at "
                         "least one slot")
    for name, t in dict(k=k, v=v).items():
        if has_storage(t) and not _aligned(t):
            raise ValueError(f"decode_attention: {name} must be 16-byte "
                             "aligned with strides in 16-byte steps")


def _flops(q, k, *args, out_shape=None):
    B, Hq, hd = q
    return 4 * B * Hq * k[1] * hd


@kernel_op("decode_attention(Tensor q, Tensor k, Tensor v, Tensor kv_pos, "
           "Tensor q_pos, Tensor(a!) out, Tensor(b!)? lse, int window, "
           "int n_split, int chunk) -> ()", _flops)
def _launch(q, k, v, kv_pos, q_pos, out, lse, window, n_split, chunk):
    kernel.launch(q, k, v, kv_pos, q_pos, out, window, n_split, chunk, lse)
    decode_attention.launches += 1


def decode_attention(q, k, v, kv_pos, q_pos, window: int = 0,
                     return_lse: bool = False):
    """q (B,Hq,hd); k, v (B,T,Hkv,hd); kv_pos (B,T) int32; q_pos (B,)
    int32 -> (B,Hq,hd) in q's dtype, and with ``return_lse`` the
    (B,Hq) float32 log-sum-exp beside it."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kv_pos, q_pos, window=window,
                                    return_lse=return_lse)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"decode_attention runs on CUDA or the CPU, not "
                         f"{q.device}")
    _check(q, k, v, kv_pos, q_pos, window)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
           if return_lse else None)
    n_split, chunk = decode_splits(q.shape[0], k.shape[2], k.shape[1])
    _launch(q, k, v, kv_pos, q_pos, out, lse, window, n_split, chunk)
    return (out, lse) if return_lse else out


decode_attention.launches = 0
