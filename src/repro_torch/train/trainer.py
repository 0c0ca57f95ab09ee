"""Train step: microbatched gradient accumulation, the remat'd forward,
the chunked (vocab-parallel) cross-entropy and the optimizer update.
Counterpart of ``repro/train/trainer.py``.

The parameters are the model's own (``trainable_params``: every
parameter of the ``Transformer``, turned trainable, by its module name);
``stacked_leaves`` names the ones the reference stacks into one leaf,
which Adafactor needs.
``make_train_step(cfg, ctx, opt, num_microbatches)`` returns
``train_step(model, opt_state, batch) -> (model, opt_state, metrics)``:
the reference's step with the model in place of its parameter tree,
updated in place (``optimizer.py``). Gradients come from
``torch.autograd.grad``, in the parameters' dtype (bf16 parameters give
bf16 gradients, as JAX's do); with microbatches they are summed in
float32, each divided by the count, as the reference's scan does.

Under a ``ShardCtx`` the model holds the rank's shards and the batch is
the rank's shard of the global batch (``local_batch``). The loss is the
global batch's, the same on every rank (the cross-entropy's mean over
the batch axes carries the gradient back over their size), the model's
collectives carry the gradient across ``model`` and FSDP's gathers
reduce-scatter it over ``data``; the step then sums over the batch axes
every gradient leaf its rank holds whole along them
(``reduce_gradients``: flat float32 buckets, one collective a bucket and
axis, not one a leaf), and the optimizer takes its statistics over the
whole leaves (``optimizer.py``). ``make_batch_spec`` gives a global
batch's shapes, dtypes and specs.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.distributed.collectives import mesh_collective
from repro_torch.distributed.sharding import NamedSharding
from repro_torch.models import transformer as tfm
from repro_torch.models.common import torch_dtype
from repro_torch.models.frontends import uses_embeds
from repro_torch.train.losses import vocab_parallel_ce

AUX_COEF = 0.01   # MoE load-balance loss weight
# the logical axes of a batch's leaves
BATCH_AXES = dict(tokens=("batch", None), embeds=("batch", "seq", "act_embed"),
                  labels=("batch", "seq"))
# the elements of one gradient bucket (float32: 256 MB)
BUCKET_NUMEL = 64 * 2 ** 20
BatchSpec = collections.namedtuple("BatchSpec", "shape dtype")


def trainable_params(model) -> dict:
    """The model's parameters by module name, each requiring grad."""
    model.requires_grad_(True)
    return dict(model.named_parameters())


def stacked_leaves(model) -> list:
    """The leaves the reference stacks, as tuples of the model's
    parameter names in layer order: one for each leaf of each block of a
    layer group that repeats (``Adafactor``'s ``stacks``)."""
    out = []
    for _, kinds, reps, idx in tfm.group_layers(model.cfg):
        if reps > 1:
            for i in range(len(kinds)):
                out += [tuple(f"layers.{row[i]}.{n}" for row in idx)
                        for n, _ in model.layers[idx[0][i]].named_parameters()]
    return out


def loss_fn(model, batch, cfg, ctx=None):
    """(loss, dict(nll, aux)) of a batch: ``tokens`` (B, S+1), next-token
    prediction, or ``embeds`` (B,S,D) with ``labels`` (B,S)."""
    if "embeds" in batch:
        inp = dict(embeds=batch["embeds"])
        labels = batch["labels"]
    else:
        tokens = batch["tokens"]
        inp = dict(tokens=tokens[:, :-1])
        labels = tokens[:, 1:]
    B, S = labels.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=labels.device).expand(B, S)
    hidden, _, aux = tfm.forward(model, positions=positions, mode="train",
                                 **inp)
    w = tfm.unembed_weight(model)
    nll = vocab_parallel_ce(hidden, w, labels, cfg, ctx,
                            n_chunks=1 if cfg.analysis_mode else 8)
    return nll + AUX_COEF * aux, dict(nll=nll, aux=aux)


def value_and_grad(model, batch, cfg, ctx=None):
    """((loss, parts), grads by parameter name)."""
    params = trainable_params(model)
    with torch.enable_grad():
        loss, parts = loss_fn(model, batch, cfg, ctx)
        # a parameter the batch does not reach (``embed`` under an
        # ``embeds`` batch) gets zeros, as from jax.grad
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True, materialize_grads=True)
    return ((loss.detach(), {k: v.detach() for k, v in parts.items()}),
            dict(zip(params, grads)))


def reduce_gradients(grads, params, ctx):
    """The gradients summed over the batch axes wherever the rank holds
    the leaf whole along them (FSDP's leaves arrive summed over ``data``
    by their reduce-scatter): leaves with the same axes to sum over are
    cut into flat float32 buckets of at most ``BUCKET_NUMEL`` elements,
    each summed by one collective an axis. A new dict by name."""
    if ctx is None:
        return grads
    batch = tuple(a for a in ctx.batch_axes if ctx.size(a) > 1)
    groups = {}
    for name, p in params.items():
        axes = tuple(a for a in batch if a not in ctx.split_axes(p.axes))
        groups.setdefault(axes, []).append(name)
    out = dict(grads)
    for axes, names in groups.items():
        if not axes:
            continue
        bucket, size = [], 0
        for i, name in enumerate(names):
            bucket.append(name)
            size += grads[name].numel()
            if size >= BUCKET_NUMEL or i == len(names) - 1:
                flat = torch.cat([grads[n].float().reshape(-1)
                                  for n in bucket])
                for a in axes:
                    flat = mesh_collective("sum", flat, ctx, a)
                for n, part in zip(bucket, torch.split(
                        flat, [grads[n].numel() for n in bucket])):
                    out[n] = part.view(grads[n].shape).to(grads[n].dtype)
                bucket, size = [], 0
                del flat
    return out


def make_train_step(cfg, ctx, opt, num_microbatches: int = 1):
    def train_step(model, opt_state, batch):
        if num_microbatches <= 1:
            (loss, parts), grads = value_and_grad(model, batch, cfg, ctx)
        else:
            n = num_microbatches
            mbs = [{k: x.reshape((n, x.shape[0] // n) + x.shape[1:])[i]
                    for k, x in batch.items()} for i in range(n)]
            grads, loss = None, torch.zeros((), device=_device(batch))
            for mb in mbs:
                (l, _), g = value_and_grad(model, mb, cfg, ctx)
                if grads is None:
                    grads = {k: torch.zeros(v.shape, dtype=torch.float32,
                                            device=v.device)
                             for k, v in g.items()}
                for k, v in g.items():
                    grads[k] += v.float() / n
                loss = loss + l / n
                del g
            parts = dict(nll=loss, aux=torch.zeros((), device=loss.device))
        params = trainable_params(model)
        grads = reduce_gradients(grads, params, ctx)
        _, opt_state, om = opt.update(grads, opt_state, params, ctx=ctx)
        metrics = dict(loss=loss, nll=parts["nll"], aux=parts["aux"], **om)
        return model, opt_state, metrics

    return train_step


def _device(batch):
    return next(iter(batch.values())).device


def make_batch_spec(cfg, ctx, batch: int, seq: int):
    """(specs, shardings) of one global batch: ``BatchSpec(shape,
    dtype)`` by name, and each leaf's ``ShardCtx.spec`` entries (the
    reference's ``PartitionSpec``). Token configs take ``tokens`` (B,
    S+1) int32, its sequence never split (S+1 need not divide the model
    axis); frontend configs ``embeds`` (B,S,D) in ``cfg.dtype`` and
    ``labels`` (B,S) int32."""
    if uses_embeds(cfg):
        specs = dict(embeds=BatchSpec((batch, seq, cfg.d_model),
                                      torch_dtype(cfg.dtype)),
                     labels=BatchSpec((batch, seq), torch.int32))
    else:
        specs = dict(tokens=BatchSpec((batch, seq + 1), torch.int32))
    return specs, {k: ctx.spec(BATCH_AXES[k]) for k in specs}


def local_batch(batch, ctx):
    """The rank's shard of a global batch (its rows over the batch
    axes); ``batch`` itself without a ctx."""
    if ctx is None:
        return batch
    return {k: ctx.local(v, BATCH_AXES[k]) for k, v in batch.items()}


def state_shardings(state, params, ctx):
    """A ``NamedSharding`` for each tensor of a training state (the
    parameters, the optimizer's state, the error state) that lies on the
    mesh as its parameter does, None for the rest (the step count): the
    ``shardings`` of ``checkpoint.ckpt``'s save and restore. A dict keyed
    by parameter names maps each value to its parameter: a tensor of the
    parameter's shape, or Adafactor's moments of it."""
    def moment(key, p, t):
        if key == "v" or t.dim() == 0:
            axes = p.axes if key == "v" else ()
        elif key == "vr":
            axes = p.axes[:-1]
        else:
            axes = p.axes if p.dim() == 1 else p.axes[:-2] + p.axes[-1:]
        return NamedSharding(ctx, axes)

    def like(node, p):
        if isinstance(node, dict):
            return {k: moment(k, p, v) for k, v in node.items()}
        return NamedSharding(ctx, p.axes)

    def walk(tree):
        if isinstance(tree, dict):
            if tree and set(tree) <= set(params):
                return {k: like(v, params[k]) for k, v in tree.items()}
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return None

    return walk(state)
