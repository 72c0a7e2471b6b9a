"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) vocab=163840,
MoE 384 experts top-8 (d_ff_expert=2048) + 1 shared expert, 1 leading dense
layer. Trillion-param MoE (paper-table entry). [arXiv:2501.kimi2]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    source="arXiv:2501.kimi2",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=18432,  # the single leading dense layer
    vocab_size=163_840,
    num_experts=384,
    top_k=8,
    moe_d_ff=2048,
    num_shared_experts=1,
    shared_d_ff=2048,
    first_k_dense=1,
    supports_long_context=False,  # full attention
)

SMOKE = CONFIG.replace(
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    num_experts=4,
    top_k=2,
    moe_d_ff=128,
    num_shared_experts=1,
    shared_d_ff=128,
    first_k_dense=1,
    param_dtype="float32",
    dtype="float32",
)
