"""Int8 error-feedback gradient compression, the compressed all-reduce,
and the collectives through which every mesh path of the port runs.
Counterpart of ``repro/distributed/collectives.py``.

``mesh_collective`` runs a sum, max, mean, gather or reduce-scatter over
one mesh axis of a ``ShardCtx`` (the reference's ``psum``/``pmean``/
``all_gather`` inside its ``shard_map``s, and what GSPMD inserts for its
FSDP and data-parallel gradients), or gathers a host object over a
group, and counts each call by kind with its bytes and seconds
(``counts``; the ``mesh`` lines of ``chip_smoke.py`` print them). The
rule on the backend: under NCCL a CUDA tensor is reduced where it lies;
under gloo, which handles CUDA tensors and bfloat16 only in part, a CUDA
tensor is staged through host memory (its bytes counted as
``staged_bytes``), a bfloat16 gather travels as its bytes (gloo gathers
no 16-bit integers), a reduce-scatter is an all-reduce cut to the rank's
part (gloo has none), and where every rank of the group runs on this
host every tensor collective passes through a host buffer they all map
(``_Slots``) instead of gloo's loopback TCP. Sums, maxima and means are
taken in float32 whatever the tensor's dtype, in rank order where the
ranks add them, and cast back once.

The model's and the loss's mesh paths carry gradients through five
``torch.autograd.Function``s built on it, Megatron's pairs:

- ``all_sum``: an all-reduce; the backward passes the gradient through
  (the row-parallel output: each rank's partial sum is one term);
- ``copy_to``: the identity; the backward is an all-reduce sum (where a
  tensor replicated over the axis enters the rank's own work, each rank's
  gradient is one term of the whole);
- ``all_gather``: the ranks' parts concatenated; the backward takes the
  rank's part;
- ``fsdp_gather``: a parameter's ``embed`` dim gathered over ``data``,
  counted as kind ``fsdp_gather``; the backward is a reduce-scatter
  (kind ``reduce_scatter``: the sum over ``data``, cut to the rank's
  part);
- ``all_mean``: an all-reduce mean of a value whose gradient is the same
  on every rank (the loss over the batch axes); the backward divides it
  by the axis size;

and Megatron's sequence-parallel pair, for a residual stream whose
sequence is cut over ``model`` (``seq`` on ``model``):

- ``gather_seq``: the ranks' slices concatenated along the sequence (kind
  ``gather``); the backward is a reduce-scatter (kind
  ``reduce_scatter``): each rank's gradient of the whole sequence is one
  term, and the rank keeps its slice of the sum;
- ``scatter_seq``: the rank's slice of the sum over the axis (kind
  ``reduce_scatter``), the row-parallel exit; the backward gathers the
  slices (kind ``gather``).

``all_gather`` and ``all_sum`` are right only where every rank's gradient
downstream is already whole; inside a block under sequence parallelism
the pair above takes their place.

``first_of`` gives every rank the value of the axis's rank 0, its
backward dividing by the axis size: the reference's ``shard_map``
output declared replicated where the shards differ (the MoE's aux loss
over data shards).

Each returns its input itself where the axis has one rank, and runs
``mesh_collective`` alone where autograd records nothing (serving), so
the forward values are the collectives' own.

``compress_gradients`` quantizes and dequantizes each gradient leaf with
error feedback: the update the optimizer sees is exactly what a
compressed data-parallel all-reduce would deliver, and the quantization
error is carried to the next step, not dropped. ``compressed_psum`` is
that all-reduce over a mesh axis: each rank quantizes with its own scale
and error, and the dequantized values are summed. Trees are nested dicts
of tensors (``repro_torch.tree``).
"""
from __future__ import annotations

import os
import socket
import tempfile
import time

import torch

from repro_torch.tree import tree_map

KINDS = ("sum", "max", "mean", "gather", "gather_object", "fsdp_gather",
         "reduce_scatter")
# under gloo, ranks on one host pass their tensors through a buffer they
# all map (``_Slots``): memory copies and two barriers, where gloo's
# loopback TCP moved 0.25-0.7 GB/s (an H100 host: phase 8's first runs)
_SHARED: dict = {}
_COUNTS: dict = {}


def reset_counts() -> None:
    _COUNTS.clear()


def counts() -> dict:
    """kind -> {calls, bytes, result_bytes, staged_bytes, seconds} since
    the last ``reset_counts``; ``bytes`` is what this rank sent (float32
    for sums, maxima and means), ``result_bytes`` what the collective
    gave it, in the tensor's dtype (the reference dry run's count of an
    HLO collective's result)."""
    return {k: dict(v) for k, v in _COUNTS.items()}


def _count(kind, nbytes, staged, seconds, result=0):
    c = _COUNTS.setdefault(kind, dict(calls=0, bytes=0, result_bytes=0,
                                      staged_bytes=0, seconds=0.0))
    c["calls"] += 1
    c["bytes"] += nbytes
    c["result_bytes"] += result
    c["staged_bytes"] += staged
    c["seconds"] += seconds


def mesh_collective(kind: str, x, ctx=None, axis: str = "model",
                    dim: int = -1, group=None):
    """``kind`` over the ranks of mesh axis ``axis`` of ``ctx`` (or over
    ``group``): "sum", "max" and "mean" of a tensor, in float32, returned
    in its dtype on its device; "gather" (and "fsdp_gather", counted
    apart), the ranks' tensors concatenated along ``dim`` in rank order;
    "reduce_scatter", the rank's part along ``dim`` of the sum;
    "gather_object", the list of the ranks' picklable ``x``. Returns
    ``x`` itself (a list of one for "gather_object") when the axis has
    one rank. Records no gradient."""
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
    d = dim % max(x.dim(), 1)
    if gloo and _slots(group):
        out, nbytes = _shared_exchange(kind, x, d, n, _slots(group), group)
    elif kind in ("gather", "fsdp_gather"):
        y = x.detach().contiguous()
        if gloo and y.dtype == torch.bfloat16:
            y = y.view(torch.uint8)       # the last dim's bytes
        if staged:
            y = y.cpu()
        parts = [torch.empty_like(y) for _ in range(n)]
        dist.all_gather(parts, y, group=group)
        out = torch.cat(parts, dim=d)
        if gloo and x.dtype == torch.bfloat16:
            out = out.view(torch.bfloat16)
        nbytes = y.numel() * y.element_size()
    elif kind == "reduce_scatter" and not gloo:
        y = x.detach().float().movedim(d, 0).contiguous()
        out = torch.empty((y.shape[0] // n, *y.shape[1:]),
                          dtype=torch.float32, device=y.device)
        dist.reduce_scatter_tensor(out, y, group=group)
        out = out.movedim(0, d).to(x.dtype)
        nbytes = y.numel() * y.element_size()
    else:
        y = x.detach().to("cpu" if staged else x.device, torch.float32,
                          copy=True)
        op = dist.ReduceOp.MAX if kind == "max" else dist.ReduceOp.SUM
        dist.all_reduce(y, op=op, group=group)
        out = y / n if kind == "mean" else y
        if kind == "reduce_scatter":
            part = out.shape[d] // n
            out = out.narrow(d, dist.get_rank(group) * part, part)
        out = out.to(x.dtype)
        nbytes = y.numel() * y.element_size()
    out = out.to(x.device)
    _count(kind, nbytes, 2 * nbytes if staged else 0,
           time.perf_counter() - t0, out.numel() * out.element_size())
    return out


class _Slots:
    """A host buffer that every rank of a group maps, one slot a rank: a
    file in the temporary directory, unlinked once all have mapped it,
    grown (a new file) when a collective needs more."""

    def __init__(self, group):
        import torch.distributed as dist

        self.group, self.n = group, dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.buf, self.slot = None, 0

    def fit(self, nbytes):
        """The (ranks, slot bytes) buffer, its slots at least ``nbytes``."""
        import torch.distributed as dist

        if self.buf is None or nbytes > self.slot:
            slot = -(-max(nbytes, 2 * self.slot, 64) // 64) * 64
            path = [None] * self.n
            if self.rank == 0:
                fd, path[0] = tempfile.mkstemp(prefix="repro_mesh_")
                os.ftruncate(fd, slot * self.n)
                os.close(fd)
            dist.all_gather_object(path, path[self.rank], group=self.group)
            # a normal tensor, written in and out of inference mode
            with torch.inference_mode(False):
                self.buf = torch.from_file(
                    path[0], shared=True, size=slot * self.n,
                    dtype=torch.uint8).view(self.n, slot)
            dist.barrier(group=self.group)
            if self.rank == 0:
                os.unlink(path[0])
            self.slot = slot
        return self.buf


def _slots(group):
    """The group's ``_Slots`` where all its ranks run on this host, else
    False; asked of the ranks once a group."""
    import torch.distributed as dist

    if group not in _SHARED:
        with open("/proc/sys/kernel/random/boot_id") as f:
            here = (socket.gethostname(), f.read().strip())
        hosts = [None] * dist.get_world_size(group)
        dist.all_gather_object(hosts, here, group=group)
        _SHARED[group] = (_Slots(group)
                          if all(h == hosts[0] for h in hosts) else False)
    return _SHARED[group]


def _shared_exchange(kind, x, d, n, slots, group):
    """``kind`` (a sum, max, mean, gather or reduce-scatter along dim
    ``d``) through the group's host buffer: each rank copies its tensor
    into its slot, a barrier, each reads the slots it needs (sums and
    maxima in float32, in rank order), a barrier. (out, bytes written)."""
    import torch.distributed as dist

    y = x.detach()
    if kind in ("gather", "fsdp_gather", "reduce_scatter"):
        y = y.movedim(d, 0)
    y = y.contiguous()
    flat = y.reshape(-1).view(torch.uint8)
    nb = flat.numel()
    buf = slots.fit(nb)
    buf[slots.rank, :nb].copy_(flat)
    dist.barrier(group=group)
    # the others' slots; the rank's own part is read where it lies
    parts = [y if j == slots.rank else buf[j, :nb].view(x.dtype).view(
        y.shape) for j in range(n)]
    if kind in ("gather", "fsdp_gather"):
        out = torch.empty((n * y.shape[0], *y.shape[1:]), dtype=x.dtype,
                          device=x.device)
        for j, p in enumerate(parts):
            out[j * y.shape[0]:(j + 1) * y.shape[0]].copy_(p)
        out = out.movedim(0, d)
    else:
        if kind == "reduce_scatter":
            c = y.shape[0] // n
            parts = [p[slots.rank * c:(slots.rank + 1) * c] for p in parts]
        # added where the tensor lies (the card, for a staged one)
        parts = [p.to(x.device) for p in parts]
        op = torch.maximum if kind == "max" else torch.add
        acc = op(parts[0].float(), parts[1].float())
        for p in parts[2:]:
            acc = op(acc, p.float())
        out = (acc / n if kind == "mean" else acc).to(x.dtype)
        if kind == "reduce_scatter":
            out = out.movedim(0, d)
    dist.barrier(group=group)   # every rank has read the slots
    return out, nb


def _axes(ctx, axis) -> tuple:
    """The mesh axes of ``axis`` (a name, a tuple of names or None) that
    have more than one rank under ``ctx``."""
    if ctx is None or axis is None:
        return ()
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    return tuple(a for a in names if ctx.size(a) > 1)


def _recorded(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _over(kind, x, ctx, axes, dim=-1):
    for a in axes:
        x = mesh_collective(kind, x, ctx, a, dim)
    return x


def _size(ctx, axes) -> int:
    n = 1
    for a in axes:
        n *= ctx.size(a)
    return n


def _first(x, ctx, axes):
    for a in axes:
        x = mesh_collective("gather", x[None], ctx, a, dim=0)[0]
    return x


# each function of ``_Mesh``: its forward over the axes, and what its
# backward does with the gradient (passes it, sums it over the axes, or
# divides it by their size)
_FORWARD = {"sum": (lambda x, c, a: _over("sum", x, c, a), "pass"),
            "copy": (lambda x, c, a: x.view_as(x), "sum"),
            "mean": (lambda x, c, a: _over("mean", x, c, a), "divide"),
            "first": (_first, "divide")}


class _Mesh(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axes, kind):
        fwd, fctx.bwd = _FORWARD[kind]
        fctx.ctx, fctx.axes = ctx, axes
        return fwd(x, ctx, axes)

    @staticmethod
    def backward(fctx, g):
        if fctx.bwd == "sum":
            g = _over("sum", g, fctx.ctx, fctx.axes)
        elif fctx.bwd == "divide":
            g = g / _size(fctx.ctx, fctx.axes)
        return g, None, None, None


def _mesh(kind, x, ctx, axis):
    axes = _axes(ctx, axis)
    if not axes or (kind == "copy" and not _recorded(x)):
        return x
    if not _recorded(x):
        return _FORWARD[kind][0](x, ctx, axes)
    return _Mesh.apply(x, ctx, axes, kind)


class _Gather(torch.autograd.Function):
    """The ranks' parts along ``dim`` over one axis; the backward keeps
    the rank's part (``kind`` "fsdp_gather": the sum over the axis
    first, a reduce-scatter)."""

    @staticmethod
    def forward(fctx, x, ctx, axis, dim, kind):
        fctx.ctx, fctx.axis, fctx.kind = ctx, axis, kind
        fctx.dim, fctx.part = dim % x.dim(), x.shape[dim]
        return mesh_collective(kind, x, ctx, axis, dim)

    @staticmethod
    def backward(fctx, g):
        if fctx.kind == "fsdp_gather":
            g = mesh_collective("reduce_scatter", g, fctx.ctx, fctx.axis,
                                fctx.dim)
        else:
            g = g.narrow(fctx.dim, fctx.ctx.index(fctx.axis) * fctx.part,
                         fctx.part)
        return g, None, None, None, None


def _gather(kind, x, ctx, axis, dim):
    if not _axes(ctx, axis):
        return x
    if not _recorded(x):
        return mesh_collective(kind, x, ctx, axis, dim)
    return _Gather.apply(x, ctx, axis, dim, kind)


class _Seq(torch.autograd.Function):
    """``gather_seq`` (``kind`` "gather") and ``scatter_seq`` (kind
    "reduce_scatter") along ``dim`` over one axis, each the other's
    backward."""

    @staticmethod
    def forward(fctx, x, ctx, axis, dim, kind):
        fctx.ctx, fctx.axis, fctx.dim = ctx, axis, dim
        fctx.back = "reduce_scatter" if kind == "gather" else "gather"
        return mesh_collective(kind, x, ctx, axis, dim)

    @staticmethod
    def backward(fctx, g):
        return (mesh_collective(fctx.back, g, fctx.ctx, fctx.axis,
                                fctx.dim), None, None, None, None)


def _seq(kind, x, ctx, axis, dim):
    if not _axes(ctx, axis):
        return x
    if not _recorded(x):
        return mesh_collective(kind, x, ctx, axis, dim)
    return _Seq.apply(x, ctx, axis, dim, kind)


def gather_seq(x, ctx, axis="model", dim=1):
    """The ranks' sequence slices of ``x`` concatenated along ``dim``;
    the gradient is reduce-scattered back to the rank's slice."""
    return _seq("gather", x, ctx, axis, dim)


def scatter_seq(x, ctx, axis="model", dim=1):
    """The rank's slice along ``dim`` of the sum of ``x`` over ``axis``;
    the gradient's slices are gathered."""
    return _seq("reduce_scatter", x, ctx, axis, dim)


def all_sum(x, ctx, axis="model"):
    """The sum of ``x`` over ``axis`` (a mesh axis or a tuple of them);
    the gradient passes through."""
    return _mesh("sum", x, ctx, axis)


def copy_to(x, ctx, axis="model"):
    """``x`` itself; its gradient is summed over ``axis``."""
    return _mesh("copy", x, ctx, axis)


def all_mean(x, ctx, axis):
    """The mean of ``x`` over ``axis``; the gradient, the same on every
    rank, is divided by the axis size."""
    return _mesh("mean", x, ctx, axis)


def first_of(x, ctx, axis):
    """The value of rank 0 along ``axis`` on every rank: what the
    reference's ``shard_map`` returns for an output it declares
    replicated (``out_specs=PS()``) where the ranks' values differ. The
    gradient is divided by the axis size, as that output's transpose
    divides it."""
    return _mesh("first", x, ctx, axis)


def all_gather(x, ctx, axis="model", dim=-1):
    """The ranks' ``x`` concatenated along ``dim``; the gradient is cut to
    the rank's part."""
    return _gather("gather", x, ctx, axis, dim)


def fsdp_gather(p, ctx, axis="data", dim=0):
    """A parameter's shard gathered whole along ``dim`` over ``axis``;
    the gradient is reduce-scattered back to the rank's shard."""
    return _gather("fsdp_gather", p, ctx, axis, dim)


def quantize_int8(x, err, ctx=None, axes=()):
    """Error-feedback int8 quantization. Returns (q, scale, new_err):
    the scale is max |x + err| / 127 (at least 1e-12), q rounds half to
    even and clips to [-127, 127], all in float32 as the reference.
    ``x`` may be a rank's shard of a leaf split over the mesh ``axes`` of
    ``ctx``: the max is then the whole leaf's."""
    xf = x.float() + err
    amax = xf.abs().max()
    for a in axes:
        amax = mesh_collective("max", amax, ctx, a)
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return q, scale, xf - deq


def dequantize_int8(q, scale):
    return q.float() * scale


def compressed_psum(x, axis: str, err, ctx):
    """The sum over mesh axis ``axis`` of the ranks' int8-quantized ``x``
    (each rank its own scale, with error feedback), and this rank's new
    error: ``(y, new_err)``, y in float32."""
    q, scale, new_err = quantize_int8(x, err)
    return mesh_collective("sum", dequantize_int8(q, scale), ctx,
                           axis), new_err


def init_error_state(tree):
    """Zeros in float32, one per leaf."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), tree)


def compress_gradients(grads, err_state, ctx=None, params=None):
    """(dequantized grads, new error state), leaf by leaf. Under ``ctx``
    each leaf is the rank's shard of the parameter of the same name in
    ``params`` (whose ``axes`` say how it is split), scaled as the whole
    leaf."""
    if ctx is None:
        qs = tree_map(quantize_int8, grads, err_state)
    else:
        qs = {k: quantize_int8(g, err_state[k], ctx,
                               ctx.split_axes(params[k].axes))
              for k, g in grads.items()}      # (q, scale, err) leaves
    return (tree_map(lambda t: dequantize_int8(t[0], t[1]), qs),
            tree_map(lambda t: t[2], qs))
