"""Model configuration for the assigned architecture pool: the port's
copy of the ``ModelConfig`` registry of ``repro/configs/base.py``.

Every architecture from the task sheet is expressed as a ``ModelConfig``;
``reduced()`` derives the CPU-test variant of the same family;
``SHAPES`` is the reference's table of input shapes (the cache
templates' batch and length).
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
    # Kept for field parity with repro.configs, where it routes the model
    # through the Pallas kernels. The port never reads it: the tensors'
    # device decides (CPU -> plain version, CUDA -> kernel or raise).
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

    # -- parameter counting ------------------------------------------------
    def param_counts(self) -> dict:
        """Returns dict(total=..., active=...) parameter counts (no frontend)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.hd
        embed = V * D * (1 if self.tie_embeddings else 2)
        total = embed
        active = embed
        for kind in self.layer_kinds():
            norms = 2 * D
            if kind in ("attn", "local", "attn_dense"):
                attn = D * self.n_heads * hd + 2 * D * self.n_kv_heads * hd \
                    + self.n_heads * hd * D
                if self.qkv_bias:
                    attn += (self.n_heads + 2 * self.n_kv_heads) * hd
            elif kind == "rglru":
                R = self.lru_width or D
                # in/out proj (2 branches in, 1 out), conv1d, gates, decay
                attn = 2 * D * R + R * D + self.conv1d_width * R + 2 * R * R + R
            elif kind == "rwkv":
                H, rhd = self.n_rwkv_heads, self.rwkv_head_dim
                # r,k,v,g,o projections + lora decay + u + token-shift mus
                attn = 5 * D * D + 2 * D * 64 + H * rhd + 6 * D
            else:
                raise ValueError(kind)
            if self.mlp_type == "swiglu":
                dense_mlp = 3 * D * F
            else:
                dense_mlp = 2 * D * F
            if kind == "rwkv":
                dense_mlp = 2 * D * F + D * F  # channel-mix (r, k, v)
            if self.moe and kind != "attn_dense" and kind not in ("rglru", "rwkv"):
                router = D * self.n_experts
                experts = self.n_experts * 3 * D * F
                shared = self.n_shared_experts * 3 * D * F
                mlp_total = router + experts + shared
                mlp_active = router + self.top_k * 3 * D * F + shared
            else:
                mlp_total = mlp_active = dense_mlp
            total += norms + attn + mlp_total
            active += norms + attn + mlp_active
        return dict(total=total, active=active)


# ---------------------------------------------------------------------------
# Input shapes (assigned per task sheet; shared by the whole LM pool)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


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


# ---------------------------------------------------------------------------
# Reduced (smoke-test) variants: same family, tiny dims.
# ---------------------------------------------------------------------------


def reduced(cfg: ModelConfig) -> ModelConfig:
    """A tiny config of the same family for CPU smoke tests."""
    n_layers = max(2, len(cfg.block_pattern))
    if cfg.moe and cfg.first_k_dense:
        n_layers = max(n_layers, cfg.first_k_dense + 1)
    heads = 0 if cfg.n_heads == 0 else 4
    kv = 0 if cfg.n_kv_heads == 0 else min(cfg.n_kv_heads, 2)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        n_layers=n_layers,
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16 if heads else 0,
        d_ff=128,
        vocab_size=512,
        n_experts=8 if cfg.moe else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        top_k=min(cfg.top_k, 2) if cfg.moe else 0,
        # smoke tests need drop-free dispatch so prefix+decode == full
        # forward exactly (production keeps the 1.5 default)
        capacity_factor=4.0,
        window=min(cfg.window, 16) if cfg.window else 0,
        lru_width=64 if cfg.lru_width else 0,
        lru_gate_blocks=4,
        rwkv_head_dim=16,
        dtype="float32",
        param_dtype="float32",
        remat=False,
        scan_layers=True,
    )
