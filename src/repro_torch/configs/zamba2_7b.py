"""zamba2-7b [hybrid] — 81L d_model=3584 vocab=32000, Mamba2 backbone
(ssm_state=64) + ONE shared attention/MLP block (32H, d_ff=14336) applied
after every 6 Mamba layers (81 = 13x6 + 3 leading). [arXiv:2411.15242]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    source="arXiv:2411.15242",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32_000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=128,
    hybrid_attn_every=6,
    supports_long_context=True,  # O(1)-state Mamba decode
)

SMOKE = CONFIG.replace(
    num_layers=3,  # 1 leading mamba + 1 group of 2 + shared attn
    hybrid_attn_every=2,
    d_model=128,
    num_heads=2,
    num_kv_heads=2,
    head_dim=64,
    d_ff=256,
    vocab_size=512,
    ssm_state=16,
    ssm_head_dim=32,
    ssm_chunk=16,
    param_dtype="float32",
    dtype="float32",
)
