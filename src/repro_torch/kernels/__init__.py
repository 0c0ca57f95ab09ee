"""Hand-written Hopper kernels of the port.

Each kernel subpackage keeps the reference's three files, plus its
source:
  kernel.py — builds the CUDA source at first use and launches it
  ops.py    — the public wrapper: the plain version for CPU tensors, the
              kernel (or an error) for CUDA tensors, and a launch count
  ref.py    — the plain PyTorch version, held against the kernel

Only ``matern_score`` is ported so far; the model-execution kernels
(flash/decode attention, the RWKV6 and RG-LRU scans) wait for the model
layer.
"""
from repro_torch.kernels.matern_score.ops import matern_score  # noqa: F401
from repro_torch.kernels.matern_score.ref import matern_score_ref  # noqa: F401

WRAPPERS = {"matern_score": matern_score}


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
