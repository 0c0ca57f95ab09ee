"""State carried across from the JAX package.

:func:`from_reference` turns a ``repro`` pytree, given as numpy arrays
(``np.asarray`` of each JAX leaf), into the port's dict of tensors on a
device, with the reference's dtypes: JAX runs with x64 off, so floats
are float32 and integers int32; bools stay bool. The pytrees are a
``jax_cost.make_params``/``stack_params`` dict and a fitted GP posterior
cache (``theta``, ``L``, ``alpha``, ``y_mu``, ``y_sigma``, ``x``,
``mask``); nested dicts convert leaf by leaf. The tests use it to feed
both packages the same GP and constraint surface.
"""
from __future__ import annotations

import numpy as np
import torch


def _dtype(a: np.ndarray) -> torch.dtype:
    if a.dtype == np.bool_:
        return torch.bool
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
    return torch.tensor(a).to(device, _dtype(a))
