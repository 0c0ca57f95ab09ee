"""VGG19 on ImageNet-Mini — the paper's primary evaluation model (§6.1).

37 splittable feature modules (torchvision indexing), FP32, batch 1.
"""
from repro_torch.configs.cnn import build_vgg19, register_cnn

CONFIG = register_cnn(build_vgg19(input_hw=224, n_classes=1000))
