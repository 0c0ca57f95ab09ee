"""Architecture configs. One module per assigned architecture.

The port's own copy of ``repro.configs`` (same names, same values), so
``repro_torch`` never imports the JAX package.

``get_config(name)`` / ``list_configs()`` are the public entry points.
"""
import importlib

from repro_torch.configs.base import (  # noqa: F401
    SHAPES, ModelConfig, ShapeConfig, get_config, list_configs, reduced,
    register, shape_applicable,
)

_ARCH_MODULES = [
    "kimi_k2_1t_a32b",
    "qwen2_moe_a2_7b",
    "qwen2_1_5b",
    "deepseek_7b",
    "h2o_danube_3_4b",
    "starcoder2_15b",
    "musicgen_large",
    "recurrentgemma_2b",
    "rwkv6_3b",
    "internvl2_26b",
    "vgg19_imagenet",     # paper's own model (conv profile, §6.1)
    "resnet101_tiny",     # paper's second pair (Fig. 8)
]

_loaded = False


def load_all():
    global _loaded
    if _loaded:
        return
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _loaded = True
