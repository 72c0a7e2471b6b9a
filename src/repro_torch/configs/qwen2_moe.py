"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (kv=16) vocab=151936,
60 routed experts top-4 (d_ff_expert=1408) + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=5632,
    vocab_size=151_936,
    num_experts=60,
    top_k=4,
    moe_d_ff=1408,
    num_shared_experts=4,
    shared_d_ff=5632,
    first_k_dense=0,
    supports_long_context=False,
)

SMOKE = CONFIG.replace(
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    num_experts=4,
    top_k=2,
    moe_d_ff=128,
    num_shared_experts=2,
    shared_d_ff=256,
    param_dtype="float32",
    dtype="float32",
)
