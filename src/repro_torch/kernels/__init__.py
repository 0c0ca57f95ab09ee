"""Hand-written Hopper kernels of the port.

Each kernel subpackage keeps the reference's three files, plus its
source:
  kernel.py — builds the CUDA source at first use (``nvcc.py``) and
              launches it
  ops.py    — the public wrapper: the plain version for CPU tensors, the
              kernel (or an error) for CUDA tensors, and a launch count
  ref.py    — the plain PyTorch version, held against the kernel

Ported, one for each TPU kernel of the reference: ``matern_score`` (the
BO's candidate scoring; its source also gives a candidate block's whole
posterior, ``matern_posterior``), ``flash_attention`` (full-sequence forward),
``decode_attention`` (one decode step), ``rglru_scan`` (RecurrentGemma's
RG-LRU recurrence) and ``rwkv6_scan`` (RWKV6's wkv recurrence).
"""
from repro_torch.kernels.decode_attention.ops import decode_attention  # noqa: F401
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: F401
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: F401
from repro_torch.kernels.matern_score.ops import (  # noqa: F401
    matern_posterior, matern_score)
from repro_torch.kernels.matern_score.ref import (  # noqa: F401
    matern_posterior_ref, matern_score_ref)
from repro_torch.kernels.rglru_scan.ops import rglru_scan  # noqa: F401
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref  # noqa: F401
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan  # noqa: F401
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref  # noqa: F401

WRAPPERS = {"matern_score": matern_score,
            "flash_attention": flash_attention,
            "decode_attention": decode_attention,
            "rglru_scan": rglru_scan,
            "rwkv6_scan": rwkv6_scan}


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset (a
    ``matern_posterior`` launch counts under ``matern_score``, and alone
    in ``matern_posterior.launches``)."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in (*WRAPPERS.values(), matern_posterior):
        fn.launches = 0
