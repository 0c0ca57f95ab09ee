"""Int8 error-feedback gradient compression, and the one helper through
which every collective of the port's mesh paths runs. Counterpart of
``repro/distributed/collectives.py``.

``mesh_collective`` runs a sum, max, mean or gather over one mesh axis
of a ``ShardCtx`` (the reference's ``psum``/``pmean``/``all_gather``
inside its ``shard_map``s), or gathers a host object over a group, and
counts each call by kind with its bytes and seconds (``counts``; the
``mesh`` lines of ``chip_smoke.py`` print them). The rule on the
backend: under NCCL a CUDA tensor is reduced where it lies; under gloo,
which handles CUDA tensors and bfloat16 only in part, a CUDA tensor is
staged through host memory (its bytes counted as ``staged_bytes``) and
a bfloat16 gather travels as its bytes (gloo gathers no 16-bit
integers). Sums, maxima and
means are taken in float32 whatever the tensor's dtype, and cast back
once.

``compress_gradients`` quantizes and dequantizes each gradient leaf with
error feedback: the update the optimizer sees is exactly what a
compressed data-parallel all-reduce would deliver, and the quantization
error is carried to the next step, not dropped. Trees are nested dicts
of tensors (``repro_torch.tree``). ``compressed_psum``, the all-reduce
itself over ``data``, comes with training under a mesh.
"""
from __future__ import annotations

import time

import torch

from repro_torch.tree import tree_map

KINDS = ("sum", "max", "mean", "gather", "gather_object")
_COUNTS: dict = {}


def reset_counts() -> None:
    _COUNTS.clear()


def counts() -> dict:
    """kind -> {calls, bytes, staged_bytes, seconds} since the last
    ``reset_counts``; ``bytes`` is what this rank sent."""
    return {k: dict(v) for k, v in _COUNTS.items()}


def _count(kind, nbytes, staged, seconds):
    c = _COUNTS.setdefault(kind, dict(calls=0, bytes=0, staged_bytes=0,
                                      seconds=0.0))
    c["calls"] += 1
    c["bytes"] += nbytes
    c["staged_bytes"] += staged
    c["seconds"] += seconds


def mesh_collective(kind: str, x, ctx=None, axis: str = "model",
                    dim: int = -1, group=None):
    """``kind`` over the ranks of mesh axis ``axis`` of ``ctx`` (or over
    ``group``): "sum", "max" and "mean" of a tensor, in float32, returned
    in its dtype on its device; "gather", the ranks' tensors
    concatenated along ``dim`` in rank order; "gather_object", the list
    of the ranks' picklable ``x``. Returns ``x`` itself (a list of one
    for "gather_object") when the axis has one rank."""
    import torch.distributed as dist

    if kind not in KINDS:
        raise ValueError(f"collective kind {kind!r} is not one of {KINDS}")
    if group is None and ctx is not None:
        group = ctx.group(axis)
    if group is None:
        return [x] if kind == "gather_object" else x
    t0 = time.perf_counter()
    n = dist.get_world_size(group)
    if kind == "gather_object":
        out = [None] * n
        dist.all_gather_object(out, x, group=group)
        _count(kind, 0, 0, time.perf_counter() - t0)
        return out
    gloo = dist.get_backend(group) == "gloo"
    staged = gloo and x.device.type == "cuda"
    if kind == "gather":
        y = x.detach().contiguous()
        if gloo and y.dtype == torch.bfloat16:
            y = y.view(torch.uint8)       # the last dim's bytes
        if staged:
            y = y.cpu()
        parts = [torch.empty_like(y) for _ in range(n)]
        dist.all_gather(parts, y, group=group)
        out = torch.cat(parts, dim=dim)
        if gloo and x.dtype == torch.bfloat16:
            out = out.view(torch.bfloat16)
    else:
        y = x.detach().to("cpu" if staged else x.device, torch.float32,
                          copy=True)
        op = dist.ReduceOp.MAX if kind == "max" else dist.ReduceOp.SUM
        dist.all_reduce(y, op=op, group=group)
        out = y / n if kind == "mean" else y
        out = out.to(x.dtype)
    nbytes = y.numel() * y.element_size()
    out = out.to(x.device)
    _count(kind, nbytes, 2 * nbytes if staged else 0,
           time.perf_counter() - t0)
    return out


def quantize_int8(x, err):
    """Error-feedback int8 quantization. Returns (q, scale, new_err):
    the scale is max |x + err| / 127 (at least 1e-12), q rounds half to
    even and clips to [-127, 127], all in float32 as the reference."""
    xf = x.float() + err
    scale = torch.clamp(xf.abs().max() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return q, scale, xf - deq


def dequantize_int8(q, scale):
    return q.float() * scale


def init_error_state(tree):
    """Zeros in float32, one per leaf."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), tree)


def compress_gradients(grads, err_state):
    """(dequantized grads, new error state), leaf by leaf."""
    qs = tree_map(quantize_int8, grads, err_state)   # (q, scale, err) leaves
    return (tree_map(lambda t: dequantize_int8(t[0], t[1]), qs),
            tree_map(lambda t: t[2], qs))
