"""VGG19 in PyTorch — the paper's actual inference workload, executable as
a partitioned (device-half / server-half) forward at any of the 37
torchvision feature-module split points. Counterpart of
``repro/models/vgg.py``; backs the ``executor=`` hook of
``default_vgg19_problem`` so BO evaluations can run the real pipeline.

Layout: images and the boundary payload are NHWC at the function
boundary, as in the reference, so the payload's element count and bytes
are the reference's. Inside, the modules run on the NCHW view of the
same memory (``permute``, which is PyTorch's channels-last layout) with
``F.conv2d`` (3x3, padding 1), ``F.max_pool2d(2, 2)`` and ``relu``. The
parameters are a dict like the reference's pytree: ``convs``, a list of
(weight, bias) with each weight in ``F.conv2d``'s (out, in, 3, 3)
order, and ``fcs``, (weight (in, out), bias) as the reference keeps them.
The classifier flattens the NHWC features in H, W, C order, as the
reference does: an NCHW flatten would permute the 25088 inputs of the
first fully-connected layer.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device

# torchvision vgg19.features plan
PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
        512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]


def module_list() -> List[str]:
    mods = []
    for p in PLAN:
        if p == "M":
            mods.append("pool")
        else:
            mods.extend([f"conv{p}", "relu"])
    assert len(mods) == 37
    return mods


def init_vgg19(generator: Optional[torch.Generator] = None,
               n_classes: int = 1000, device="cuda") -> dict:
    """Weights drawn from ``generator`` (default: seed 0 on ``device``)
    at the reference's He scales: conv N(0, 2 / (9 c_in)), fully
    connected N(0, 1 / fan_in), biases zero; float32 on ``device``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    params = {"convs": [], "fcs": []}
    cin = 3
    for p in PLAN:
        if p == "M":
            continue
        cout = int(p)
        w = torch.randn((cout, cin, 3, 3), generator=generator, device=dev)
        params["convs"].append((w.mul_(math.sqrt(2.0 / (9 * cin))),
                                torch.zeros(cout, device=dev)))
        cin = cout
    for a, b in [(25088, 4096), (4096, 4096), (4096, n_classes)]:
        w = torch.randn((a, b), generator=generator, device=dev)
        params["fcs"].append((w.mul_(math.sqrt(1.0 / a)),
                              torch.zeros(b, device=dev)))
    return params


def _apply_module(params, x, mod_idx: int, conv_idx: int):
    """Feature module ``mod_idx`` on ``x`` (NCHW view)."""
    kind = module_list()[mod_idx]
    if kind == "pool":
        return F.max_pool2d(x, 2, 2), conv_idx
    if kind == "relu":
        return F.relu(x), conv_idx
    w, b = params["convs"][conv_idx]
    return F.conv2d(x, w, b, padding=1), conv_idx + 1


def _conv_count_before(l: int) -> int:
    return sum(1 for m in module_list()[:l] if m.startswith("conv"))


def vgg19_features(params, images, lo: int = 0, hi: int = 37):
    """Apply feature modules [lo, hi). images/activation: NHWC."""
    x = images.permute(0, 3, 1, 2)
    conv_idx = _conv_count_before(lo)
    for m in range(lo, hi):
        x, conv_idx = _apply_module(params, x, m, conv_idx)
    return x.permute(0, 2, 3, 1)


def vgg19_classifier(params, feats):
    """Logits from NHWC features, flattened in H, W, C order."""
    x = feats.reshape(feats.shape[0], -1)
    for i, (w, b) in enumerate(params["fcs"]):
        x = x @ w + b
        if i < 2:
            x = F.relu(x)
    return x


def wireless_hop(act) -> Tuple[torch.Tensor, int]:
    """The 'wireless' hop of the boundary payload: a synchronous copy to
    host memory and back to ``act``'s device. Returns the payload as the
    server half receives it and its bytes."""
    payload = act.to("cpu", copy=True)
    return (payload.to(act.device),
            payload.numel() * payload.element_size())


def split_forward(params, images, l: int) -> Tuple[torch.Tensor, int]:
    """Device half [0, l) -> boundary payload -> server half [l, 37) +
    classifier. Returns (logits, boundary_bytes)."""
    act = vgg19_features(params, images, 0, l)
    received, boundary_bytes = wireless_hop(act)
    feats = vgg19_features(params, received, l, 37)
    return vgg19_classifier(params, feats), boundary_bytes


def make_executor(params, images):
    """Adapter for SplitInferenceProblem(executor=...): every BO
    evaluation runs the real partitioned VGG19 forward."""
    def executor(l: int, p_w: float):
        split_forward(params, images, int(l))
    return executor
