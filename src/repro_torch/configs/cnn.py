"""CNN layer-spec machinery for the paper's own models (VGG19, ResNet101).
The port's copy of ``repro/configs/cnn.py`` (unchanged).

The paper profiles VGG19 per-module (37 splittable modules, torchvision
indexing) and ResNet101 per-block. Each ``CNNLayer`` carries enough to
compute MACs and activation bytes at any split point — exactly what the
analytic energy/delay models (Eq. 2-4) consume.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

_CNN_REGISTRY: dict = {}


@dataclasses.dataclass(frozen=True)
class CNNLayer:
    name: str
    kind: str                 # conv | relu | pool | fc | bottleneck
    macs: float               # multiply-accumulate ops for this layer
    out_elems: int            # elements of the activation produced
    server_only: bool = False  # classifier head (never on the device side)


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    input_hw: int
    input_ch: int
    n_classes: int
    layers: Tuple[CNNLayer, ...]   # splittable prefix; server_only tail last
    bytes_per_elem: int = 4        # FP32 inference (paper §6.1)

    @property
    def n_split_layers(self) -> int:
        return sum(1 for l in self.layers if not l.server_only)

    def cumulative_macs(self) -> List[float]:
        """cum_macs[i] = MACs of layers 0..i-1 (device side for split=i)."""
        out, acc = [0.0], 0.0
        for l in self.layers:
            acc += l.macs
            out.append(acc)
        return out

    def activation_bytes(self, split: int) -> float:
        """Bytes transmitted when splitting after module `split` (1-based).

        split=0 means 'transmit raw input'.
        """
        if split == 0:
            return self.input_hw * self.input_hw * self.input_ch * self.bytes_per_elem
        return self.layers[split - 1].out_elems * self.bytes_per_elem


def register_cnn(cfg: CNNConfig) -> CNNConfig:
    _CNN_REGISTRY[cfg.name] = cfg
    return cfg


def get_cnn_config(name: str) -> CNNConfig:
    from repro_torch import configs as _c
    _c.load_all()
    return _CNN_REGISTRY[name]


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------


def build_vgg19(input_hw: int = 224, n_classes: int = 1000) -> CNNConfig:
    """torchvision VGG19 ``features`` (37 modules) + classifier tail."""
    plan = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
            512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]
    layers: List[CNNLayer] = []
    hw, cin = input_hw, 3
    idx = 0
    for p in plan:
        if p == "M":
            hw //= 2
            layers.append(CNNLayer(f"pool{idx}", "pool",
                                   macs=hw * hw * cin,
                                   out_elems=hw * hw * cin))
            idx += 1
        else:
            cout = int(p)
            macs = 9 * cin * cout * hw * hw          # 3x3 conv, stride 1, pad 1
            out = hw * hw * cout
            layers.append(CNNLayer(f"conv{idx}", "conv", macs=macs, out_elems=out))
            idx += 1
            layers.append(CNNLayer(f"relu{idx}", "relu", macs=out, out_elems=out))
            idx += 1
            cin = cout
    assert len(layers) == 37, len(layers)
    # classifier tail (always server side): 25088->4096->4096->n_classes
    feat = hw * hw * cin
    tail = [(feat, 4096), (4096, 4096), (4096, n_classes)]
    for i, (a, b) in enumerate(tail):
        layers.append(CNNLayer(f"fc{i}", "fc", macs=a * b, out_elems=b,
                               server_only=True))
    return CNNConfig("vgg19-imagenet-mini", input_hw, 3, n_classes, tuple(layers))


def _bottleneck(name, hw, cin, width, stride, downsample) -> Tuple[CNNLayer, int, int]:
    cout = width * 4
    hw_out = hw // stride
    macs = (cin * width * hw * hw                    # 1x1 reduce
            + 9 * width * width * hw_out * hw_out    # 3x3
            + width * cout * hw_out * hw_out)        # 1x1 expand
    if downsample:
        macs += cin * cout * hw_out * hw_out
    out = hw_out * hw_out * cout
    return CNNLayer(name, "bottleneck", macs=macs, out_elems=out), hw_out, cout


def build_resnet101(input_hw: int = 64, n_classes: int = 200) -> CNNConfig:
    """ResNet101 at Tiny-ImageNet resolution, split at block granularity."""
    layers: List[CNNLayer] = []
    hw = input_hw // 2                                # stem conv 7x7 s2
    layers.append(CNNLayer("stem", "conv",
                           macs=49 * 3 * 64 * hw * hw,
                           out_elems=hw * hw * 64))
    hw //= 2                                          # maxpool s2
    layers.append(CNNLayer("stempool", "pool", macs=hw * hw * 64,
                           out_elems=hw * hw * 64))
    cin = 64
    stage_blocks = [(64, 3), (128, 4), (256, 23), (512, 3)]
    for s, (width, n) in enumerate(stage_blocks):
        for b in range(n):
            stride = 2 if (b == 0 and s > 0) else 1
            lyr, hw, cin = _bottleneck(f"s{s}b{b}", hw, cin, width, stride,
                                       downsample=(b == 0))
            layers.append(lyr)
    layers.append(CNNLayer("gap", "pool", macs=hw * hw * cin, out_elems=cin))
    layers.append(CNNLayer("fc", "fc", macs=cin * n_classes,
                           out_elems=n_classes, server_only=True))
    return CNNConfig("resnet101-tiny-imagenet", input_hw, 3, n_classes,
                     tuple(layers))
