"""Bayes-Split-Edge in PyTorch and CUDA: the port of ``repro`` (JAX on a
TPU) to an NVIDIA H100.

Same layout and names as ``repro``. The package imports ``torch`` and
``numpy``, never ``jax`` and nothing of ``repro``. Entry points run on
the card (``device="cuda"``) unless the caller passes ``device="cpu"``.
"""
