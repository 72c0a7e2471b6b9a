"""ArchConfig: one immutable description per architecture.

The port's own copy of ``repro.configs.base.ArchConfig`` (the port imports
nothing of the JAX package). Field names, defaults and ``layer_kinds`` are
identical, so a config means the same model in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm | encoder
    source: str  # citation
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // num_heads

    # --- attention pattern ---
    # cycle of layer kinds, tiled over depth: "global" | "local"
    attn_pattern: Tuple[str, ...] = ("global",)
    sliding_window: int = 0  # for "local" layers
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    rope_theta: float = 10_000.0
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"  # silu | gelu (tanh approximation, as jax.nn.gelu)
    mlp_type: str = "glu"  # glu | mlp
    tie_embeddings: bool = True
    use_rope: bool = True
    pos_embed: str = "rope"  # rope | sinusoidal | learned
    max_position: int = 131_072

    # --- MLA ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    shared_d_ff: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- SSM ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    hybrid_attn_every: int = 0

    # --- RWKV ---
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64

    # --- encoder-decoder ---
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500

    # --- VLM ---
    cross_attn_every: int = 0
    vision_dim: int = 0
    vision_tokens: int = 1601

    # --- encoder-only classification ---
    num_labels: int = 0

    # --- numerics / memory ---
    dtype: str = "bfloat16"  # activation dtype
    param_dtype: str = "float32"
    remat: bool = True

    sharded_ce: bool = False
    attn_chunk: int = 0
    supports_long_context: bool = False

    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer attention kind, attn_pattern tiled over depth."""
        p = self.attn_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
