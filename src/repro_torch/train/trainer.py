"""Train step: microbatched gradient accumulation, the remat'd forward,
the chunked cross-entropy and the optimizer update. Counterpart of
``repro/train/trainer.py`` without a mesh.

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
``make_batch_spec`` belongs to the dry run and waits for the mesh
tooling.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as tfm
from repro_torch.train.losses import vocab_parallel_ce

AUX_COEF = 0.01   # MoE load-balance loss weight


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
        _, opt_state, om = opt.update(grads, opt_state, params)
        metrics = dict(loss=loss, nll=parts["nll"], aux=parts["aux"], **om)
        return model, opt_state, metrics

    return train_step


def _device(batch):
    return next(iter(batch.values())).device
