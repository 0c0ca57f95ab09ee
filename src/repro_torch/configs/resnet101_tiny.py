"""ResNet101 on Tiny-ImageNet — the paper's second model/dataset pair (Fig 8).

Split at block granularity (stem + 33 bottlenecks + GAP = 36 split points).
"""
from repro_torch.configs.cnn import build_resnet101, register_cnn

CONFIG = register_cnn(build_resnet101(input_hw=64, n_classes=200))
