"""The language-model kernels' launches as operators of one
``torch.library`` library, ``repro_torch``: ``flash_attention``,
``flash_attention_bwd``, ``decode_attention``, ``rglru_scan``,
``rglru_scan_bwd``, ``rwkv6_scan`` and ``rwkv6_scan_bwd``.

Each operator writes into outputs its wrapper (``ops.py``) allocated, and
returns nothing. Its CUDA implementation is the wrapper's launch (the
pointer checks, the ``ctypes`` call, the launch count); its fake
implementation does nothing, so under ``FakeTensorMode`` (or on ``meta``
tensors) a call costs no memory and no launch, and the outputs keep the
shapes and dtypes the wrapper gave them: the dry run
(``launch/dryrun.py``) traces the card's path on a host with no card. The
wrappers send CPU tensors to their plain versions before any operator is
reached; every other device goes to the operator, whose dispatcher picks
the implementation by device. Each operator also has a FLOP formula for
``torch.utils.flop_counter.FlopCounterMode``.

The library is defined with ``torch.library.Library``, not
``torch.library.custom_op``, whose Python wrapping costs about ten times
the dispatcher's own few microseconds a call.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

LIB = torch.library.Library("repro_torch", "DEF")


def has_storage(t) -> bool:
    """Whether ``t`` has memory behind it: not a meta tensor, not a fake
    one (``FakeTensorMode``), whose pointers a check cannot read."""
    from torch._subclasses.fake_tensor import is_fake

    return t.device.type != "meta" and not is_fake(t)


def _no_launch(*args, **kwargs) -> None:
    """A fake launch: the outputs were allocated by the caller."""
    return None


def kernel_op(schema: str, flops):
    """Define ``repro_torch::<name>`` by ``schema`` (``name(args) ->
    ()``): the decorated function becomes its CUDA implementation,
    ``_no_launch`` its fake one, and ``flops(*shapes, out_shape=None)``
    (the arguments' shapes, in the schema's order; other arguments as
    given) its FLOP formula. Returns the operator's default overload,
    which the wrapper calls."""
    name = schema.split("(", 1)[0]

    def wrap(fn):
        LIB.define(schema)
        LIB.impl(name, fn, "CUDA")
        torch.library.register_fake(f"repro_torch::{name}", _no_launch,
                                    lib=LIB)
        packet = getattr(torch.ops.repro_torch, name)
        register_flop_formula(packet)(flops)
        return packet.default

    return wrap
