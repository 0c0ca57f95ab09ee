"""Public wrappers of the ``flash_attention`` kernels. Counterpart of
``repro/kernels/flash_attention/ops.py``.

For tensors on the CPU they return the plain PyTorch versions
(``ref.py``), and autograd runs through them. For CUDA tensors they
launch the hand-written kernels (``kernel.py``) or raise: there is no
fallback. Unlike the TPU wrapper they pad nothing; the kernels mask
ragged Sq and Skv themselves. Both dtypes run the forward and the
backward on the tensor cores (float32 as 3xTF32 split products) with
16-byte copies, so their tensors (q, k, v, and the backward's ``out``
and ``dout``) must be 16-byte aligned with strides in 16-byte steps; a
tensor that is not raises, it never takes a slower path.

``flash_attention`` is the model's entry. On CUDA tensors, when autograd
records (grad enabled and an input requires grad), it goes through
``FlashAttention``, a ``torch.autograd.Function`` whose forward also
writes each row's log-sum-exp and whose backward is the backward kernel
(``flash_attention_bwd``); otherwise it launches the forward alone.
``flash_attention_fwd`` and ``flash_attention_bwd`` are the two kernels
as plain calls. ``flash_attention.launches`` counts the forward's
launches, ``flash_attention_bwd.launches`` the backward's (one call is
one launch: three CUDA kernels).

Each launch is an operator of the ``repro_torch`` library
(``kernels/library.py``): ``flash_attention`` and
``flash_attention_bwd``, whose fake implementations let a fake trace
follow this path. Their FLOP formulas count the dense (Sq, Skv) score
matrix whatever the mask, as the reference's dense-attention variant
does: 4 B Hq Sq Skv hd forward (q k^T and p v) and 8 backward (dv, dp,
dq, dk; the plain backward, autograd through ``attention_ref``, also
runs the forward again, which the kernel's saved log-sum-exp replaces).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.autograd import needs_backward
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref)
from repro_torch.kernels.library import has_storage, kernel_op

DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k, v, window):
    for name, t in dict(q=q, k=k, v=v).items():
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError("flash_attention: q, k and v must share one "
                            "dtype, float32 or bfloat16; got "
                            f"{q.dtype}, {k.dtype}, {v.dtype}")
        if t.ndim != 4 or t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} must be 4-d with a "
                             "contiguous head dim")
    B, Sq, Hq, hd = q.shape
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd
            or k.shape[2] == 0 or Hq % k.shape[2]):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)} do not fit")
    if hd % 8 or not 0 < hd <= 256:
        raise ValueError(f"flash_attention: head dim {hd} is not a "
                         "multiple of 8 up to 256")
    if window < 0 or (window and Sq - k.shape[1] >= window):
        raise ValueError(f"flash_attention: window {window} leaves q rows "
                         f"with no key (Sq {Sq}, Skv {k.shape[1]})")
    if B > 65535 or Hq > 65535:
        raise ValueError("flash_attention: batch and heads must each be "
                         "at most 65535")
    _check_aligned("flash_attention", q=q, k=k, v=v)


def _check_aligned(what, **tensors):
    """Tensors 16-byte aligned with batch, sequence and head strides in
    16-byte steps, 8 bfloat16 or 4 float32 elements, as the kernels take
    them (``kernel.strides``: a dim of size 1 has none); a tensor with no
    storage, meta or fake, has no pointer to check."""
    for name, t in tensors.items():
        step = 16 // t.element_size()
        if has_storage(t) and (t.data_ptr() % 16 or any(
                s % step for s in kernel.strides(t))):
            raise ValueError(f"{what}: {str(t.dtype).split('.')[-1]} "
                             f"{name} must be 16-byte aligned with "
                             "strides in 16-byte steps")


def _device(q, what):
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{what} runs on CUDA or the CPU, not {q.device}")


def _fwd_flops(q, k, *args, out_shape=None):
    B, Sq, Hq, hd = q
    return 4 * B * Hq * Sq * k[1] * hd


def _bwd_flops(q, k, *args, out_shape=None):
    return 2 * _fwd_flops(q, k)


@kernel_op("flash_attention(Tensor q, Tensor k, Tensor v, Tensor(a!) out, "
           "Tensor(b!)? lse, bool causal, int window) -> ()", _fwd_flops)
def _launch(q, k, v, out, lse, causal, window):
    kernel.launch(q, k, v, out, causal, window, lse=lse)
    flash_attention.launches += 1


@kernel_op("flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor out, "
           "Tensor dout, Tensor lse, Tensor(a!) dq, Tensor(b!) dk, "
           "Tensor(c!) dv, bool causal, int window) -> ()", _bwd_flops)
def _launch_bwd(q, k, v, out, dout, lse, dq, dk, dv, causal, window):
    kernel.launch_bwd(q, k, v, out, dout, lse, dq, dk, dv, causal, window)
    flash_attention_bwd.launches += 1


def flash_attention_fwd(q, k, v, causal: bool = True, window: int = 0):
    """The forward with its second output: (out (B,Sq,Hq,hd) in q's
    dtype, lse float32 (B,Hq,Sq), each row's log-sum-exp in base 2)."""
    _device(q, "flash_attention")
    if q.device.type == "cpu":
        return (attention_ref(q, k, v, causal=causal, window=window),
                attention_lse_ref(q, k, causal=causal, window=window))
    _check(q, k, v, window)
    B, Sq, Hq, _ = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, Hq, Sq, dtype=torch.float32, device=q.device)
    _launch(q, k, v, out, lse, causal, window)
    return out, lse


def _check_bwd(q, k, out, lse, dout):
    B, Sq, Hq, _ = q.shape
    for name, t in dict(out=out, dout=dout).items():
        if (t.device != q.device or t.dtype != q.dtype
                or t.shape != q.shape or t.stride(-1) != 1):
            raise ValueError(f"flash_attention_bwd: {name} must match q "
                             f"{tuple(q.shape)} {q.dtype} on {q.device} "
                             "with a contiguous head dim")
    if (lse.device != q.device or lse.dtype != torch.float32
            or tuple(lse.shape) != (B, Hq, Sq) or not lse.is_contiguous()):
        raise ValueError("flash_attention_bwd: lse must be contiguous "
                         f"float32 {(B, Hq, Sq)} on {q.device}")
    _check_aligned("flash_attention_bwd", out=out, dout=dout)


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = True,
                        window: int = 0):
    """(dq, dk, dv) of ``flash_attention`` at cotangent ``dout``, in the
    inputs' dtypes. ``out`` and ``lse`` are the forward's outputs
    (``flash_attention_fwd``); the plain version for CPU tensors
    recomputes what it needs from q, k and v. ``dout`` may be strided:
    it is made contiguous."""
    _device(q, "flash_attention_bwd")
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, dout, causal=causal,
                                 window=window)
    _check(q, k, v, window)
    dout = dout.contiguous()
    _check_bwd(q, k, out, lse, dout)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_bwd(q, k, v, out, dout, lse, dq, dk, dv, causal, window)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The kernels under autograd: the forward keeps q, k, v, its output
    and its log-sum-exp; the backward is ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention_fwd(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """q (B,Sq,Hq,hd); k, v (B,Skv,Hkv,hd) -> (B,Sq,Hq,hd) in q's dtype."""
    _device(q, "flash_attention")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if needs_backward(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window)
    _check(q, k, v, window)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, None, causal, window)
    return out


flash_attention.launches = 0
flash_attention_bwd.launches = 0
