"""State carried across from the JAX package.

:func:`from_reference` turns a ``repro`` pytree, given as numpy arrays
(``np.asarray`` of each JAX leaf), into the port's dict of tensors on a
device, with the reference's dtypes: JAX runs with x64 off, so floats
are float32 and integers int32; bools stay bool. The pytrees are a
``jax_cost.make_params``/``stack_params`` dict and a fitted GP posterior
cache (``theta``, ``L``, ``alpha``, ``y_mu``, ``y_sigma``, ``x``,
``mask``); nested dicts convert leaf by leaf. The tests use it to feed
both packages the same GP and constraint surface.

:func:`model_from_reference` carries a ``repro`` model's parameter
pytree (``transformer.init_model``) into the port's ``Transformer``,
keeping each leaf's dtype; :func:`params_to_reference` is its inverse,
which the training tests use to hold gradients and updated parameters
to the reference's leaf by leaf; and :func:`vgg19_from_reference` a VGG19's
into ``models.vgg``'s layout. A JAX bfloat16 leaf arrives as numpy with
dtype ``ml_dtypes.bfloat16``, which neither ``np.issubdtype(...,
np.floating)`` nor ``torch.tensor`` accepts: it goes through float32,
which holds every bfloat16 exactly, and back to ``torch.bfloat16``.
"""
from __future__ import annotations

import numpy as np
import torch


def _is_bfloat16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def _dtype(a: np.ndarray) -> torch.dtype:
    if a.dtype == np.bool_:
        return torch.bool
    if _is_bfloat16(a):
        return torch.bfloat16
    if np.issubdtype(a.dtype, np.floating):
        return torch.float32
    if np.issubdtype(a.dtype, np.integer):
        return torch.int32
    raise TypeError(f"no reference dtype for {a.dtype}")


def from_reference(tree, device):
    """A (nested) dict of numpy arrays or scalars -> the same dict of
    tensors on ``device`` with the reference's dtypes."""
    if isinstance(tree, dict):
        return {k: from_reference(v, device) for k, v in tree.items()}
    a = np.asarray(tree)
    return _leaf(a).to(device, _dtype(a))


def _leaf(a: np.ndarray) -> torch.Tensor:
    """A numpy leaf as a CPU tensor of its own precision."""
    if _is_bfloat16(a):
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


def model_from_reference(cfg, np_params, device):
    """The port's ``Transformer`` holding a reference parameter pytree.

    ``np_params`` is the reference's tree with numpy leaves (``embed``,
    ``final_norm``, ``unembed`` unless tied, ``groups/g{gi}/b{i}``); a
    group of ``reps > 1`` stacks its layers on a leading axis, which is
    unstacked here in the reference's layer order. Each parameter takes
    its leaf's dtype (float32 or bfloat16). An MoE block's leaves land
    under the same names: ``mlp.router``, ``mlp.wg``/``wu``/``wd`` (the
    experts, stacked on E) and ``mlp.shared.wg``/``wu``/``wd``; Kimi
    K2's leading ``attn_dense`` group keeps a dense ``mlp``."""
    from repro_torch.models import transformer as tfm

    model = tfm.Transformer(cfg, device)

    def put(module, name, leaf):
        a = np.asarray(leaf)
        param = module.get_parameter(name)
        if tuple(a.shape) != tuple(param.shape):
            raise ValueError(f"{name}: reference shape {a.shape}, port "
                             f"shape {tuple(param.shape)}")
        param.data = _leaf(a).to(param.device)

    def put_tree(module, tree, prefix="", take=None):
        for key, sub in tree.items():
            if isinstance(sub, dict):
                put_tree(module, sub, f"{prefix}{key}.", take)
            else:
                put(module, prefix + key,
                    sub if take is None else np.asarray(sub)[take])

    put(model, "embed", np_params["embed"])
    if not cfg.tie_embeddings:
        put(model, "unembed", np_params["unembed"])
    put_tree(model.final_norm, np_params["final_norm"])
    for gi, kinds, reps, idx in tfm.group_layers(cfg):
        group = np_params["groups"][f"g{gi}"]
        for r, row in enumerate(idx):
            for i, layer in enumerate(row):
                put_tree(model.layers[layer], group[f"b{i}"],
                         take=r if reps > 1 else None)
    return model


def params_to_reference(model, cfg, tensors=None) -> dict:
    """The reference's parameter pytree, numpy leaves, from the port's
    model: the inverse of :func:`model_from_reference`. ``tensors`` maps
    the model's parameter names to tensors of their shapes (gradients,
    say) and defaults to the parameters themselves. Each group's layers
    are stacked on a leading axis in the reference's layer order where
    the group repeats; bfloat16 leaves come back as float32 (which holds
    them exactly), the others in their own dtype."""
    from repro_torch.models import transformer as tfm

    src = dict(model.named_parameters()) if tensors is None else tensors

    def host(t):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()

    def nest(flat: dict) -> dict:
        out: dict = {}
        for name, leaf in flat.items():
            *path, last = name.split(".")
            d = out
            for k in path:
                d = d.setdefault(k, {})
            d[last] = leaf
        return out

    tree = {"embed": host(src["embed"]),
            "final_norm": nest({n: host(src[f"final_norm.{n}"]) for n, _ in
                                model.final_norm.named_parameters()})}
    if not cfg.tie_embeddings:
        tree["unembed"] = host(src["unembed"])
    groups = {}
    for gi, kinds, reps, idx in tfm.group_layers(cfg):
        group = {}
        for i in range(len(kinds)):
            layers = [row[i] for row in idx]
            names = [n for n, _ in model.layers[layers[0]].named_parameters()]
            leaves = {}
            for n in names:
                vals = [host(src[f"layers.{layer}.{n}"]) for layer in layers]
                leaves[n] = np.stack(vals) if reps > 1 else vals[0]
            group[f"b{i}"] = nest(leaves)
        groups[f"g{gi}"] = group
    tree["groups"] = groups
    return tree


def vgg19_from_reference(np_params, device) -> dict:
    """The reference's VGG19 parameters (``repro.models.vgg.init_vgg19``,
    numpy leaves) as the port's ``models.vgg`` dict, float32 on
    ``device``: each conv kernel from the reference's HWIO to
    ``F.conv2d``'s (out, in, kh, kw), the fully-connected layers as they
    are."""
    def put(a, axes=None):
        a = np.asarray(a, np.float32)
        return torch.tensor(np.ascontiguousarray(
            a if axes is None else a.transpose(axes))).to(device)

    return {"convs": [(put(w, (3, 2, 0, 1)), put(b))
                      for w, b in np_params["convs"]],
            "fcs": [(put(w), put(b)) for w, b in np_params["fcs"]]}
