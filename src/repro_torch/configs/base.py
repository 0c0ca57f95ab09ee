"""Model configuration for the assigned architecture pool: the port's
copy of the ``ModelConfig`` registry of ``repro/configs/base.py``.

Every architecture from the task sheet is expressed as a ``ModelConfig``.
The port so far reads them only to price LM splits (``core/profiles.py``);
the shape table, parameter counting and ``reduced()`` smoke variants wait
for the model layer.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                     # 0 => attention-free (rwkv)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 => d_model // n_heads

    # --- MLP ---
    mlp_type: str = "swiglu"         # swiglu | gelu
    qkv_bias: bool = False
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0        # always-on experts (same d_ff each)
    top_k: int = 0
    first_k_dense: int = 0           # leading dense layers (Kimi K2 style)
    capacity_factor: float = 1.5
    router_dtype: str = "float32"
    # "ragged": sort + jax.lax.ragged_dot (flags full dense flops on the
    # CPU lowering); "capacity": GShard-style fixed-capacity per-expert
    # buffers + batched matmul (true grouped flops). See §Perf iteration A1.
    moe_dispatch: str = "capacity"
    # fp8 expert-weight cast before the (FSDP gather +) expert matmuls:
    # halves ZeRO-3 regather volume and decode weight streaming
    # (§Perf iterations A2/C2). bf16 master weights stay the source of
    # truth; per-expert scales keep f8e4m3 range.
    moe_weight_dtype: str = "bfloat16"

    # --- attention ---
    attn_type: str = "full"          # full | swa | none
    window: int = 0                  # sliding-window size (swa / local layers)
    rope_theta: float = 10_000.0

    # --- layer pattern (hybrid archs). Cycled over layers. ---
    # entries: "attn" | "local" | "rglru" | "rwkv"
    block_pattern: Tuple[str, ...] = ("attn",)
    lru_width: int = 0               # RG-LRU recurrence width (0 => d_model)
    lru_gate_blocks: int = 16        # block-diagonal gate blocks (TP-aligned)
    conv1d_width: int = 4            # temporal conv width in RG-LRU block
    rwkv_head_dim: int = 64

    # --- modality frontend (stub: precomputed embeddings are the input) ---
    frontend: Optional[str] = None   # None | "audio_frames" | "vision_patches"

    # --- numerics ---
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    # --- sharding strategy hints (see distributed/sharding.py) ---
    attn_sharding: str = "heads"     # heads | sequence | replicated
    moe_sharding: str = "expert"     # expert | tensor
    remat: bool = True
    scan_layers: bool = True
    # analysis_mode: variant lowered ONLY for roofline accounting — avoids
    # internal lax.scans (XLA cost_analysis counts a scan body once, not
    # x trip-count): attention takes the dense path, CE uses one chunk.
    # Never executed; never the shipped config.
    analysis_mode: bool = False
    # Route the model hot spots through the hand-written kernels
    # (kernels/*). Kept for field parity with repro.configs; the port's
    # model layer, which reads it, is not ported yet.
    use_pallas_kernels: bool = False

    # -- derived ---------------------------------------------------------
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.n_heads:
            return self.d_model // self.n_heads
        return self.rwkv_head_dim

    @property
    def n_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def pattern_for_layer(self, i: int) -> str:
        return self.block_pattern[i % len(self.block_pattern)]

    def layer_kinds(self) -> Tuple[str, ...]:
        kinds = []
        for i in range(self.n_layers):
            if self.moe and i < self.first_k_dense:
                kinds.append("attn_dense")  # dense-MLP leading layer of an MoE model
            else:
                kinds.append(self.pattern_for_layer(i))
        return tuple(kinds)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    # import the arch modules lazily so `register` has run
    from repro_torch import configs as _c  # noqa: F401
    _c.load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list:
    from repro_torch import configs as _c
    _c.load_all()
    return sorted(_REGISTRY)
