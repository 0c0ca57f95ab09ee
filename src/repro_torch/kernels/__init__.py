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
RG-LRU recurrence) and ``rwkv6_scan`` (RWKV6's wkv recurrence). Added
with no TPU counterpart, the backwards that training on the card runs
(the reference differentiates its jnp attention and scans with XLA):
``flash_attention_bwd``, ``rglru_scan_bwd`` and ``rwkv6_scan_bwd``. On
CUDA tensors that autograd records, each forward wrapper goes through
its ``torch.autograd.Function`` (``kernels.autograd``).
"""
from repro_torch.kernels.decode_attention.ops import decode_attention  # noqa: F401
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: F401
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    flash_attention, flash_attention_bwd, flash_attention_fwd)
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    attention_bwd_ref, attention_ref)
from repro_torch.kernels.matern_score.ops import (  # noqa: F401
    matern_posterior, matern_score)
from repro_torch.kernels.matern_score.ref import (  # noqa: F401
    matern_posterior_ref, matern_score_ref)
from repro_torch.kernels.rglru_scan.ops import (  # noqa: F401
    rglru_scan, rglru_scan_bwd)
from repro_torch.kernels.rglru_scan.ref import (  # noqa: F401
    rglru_scan_bwd_ref, rglru_scan_ref)
from repro_torch.kernels.rwkv6_scan.ops import (  # noqa: F401
    rwkv6_scan, rwkv6_scan_bwd, rwkv6_scan_fwd)
from repro_torch.kernels.rwkv6_scan.ref import (  # noqa: F401
    rwkv6_scan_bwd_ref, rwkv6_scan_ref)

WRAPPERS = {"matern_score": matern_score,
            "flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_bwd,
            "decode_attention": decode_attention,
            "rglru_scan": rglru_scan,
            "rglru_scan_bwd": rglru_scan_bwd,
            "rwkv6_scan": rwkv6_scan,
            "rwkv6_scan_bwd": rwkv6_scan_bwd}


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset (a
    ``matern_posterior`` launch counts under ``matern_score``, and alone
    in ``matern_posterior.launches``)."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in (*WRAPPERS.values(), matern_posterior):
        fn.launches = 0
