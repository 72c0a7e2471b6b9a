"""rwkv6-1.6b [ssm] — "Finch": 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536, data-dependent per-channel decay WKV. [arXiv:2404.05892]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    source="arXiv:2404.05892",
    num_layers=24,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=7168,
    vocab_size=65_536,
    rwkv_head_dim=64,
    rwkv_decay_lora=64,
    ssm_chunk=32,  # the (Q, Q, channel) intra-chunk block stays small
    norm="layernorm",
    use_rope=False,
    pos_embed="none",
    supports_long_context=True,  # O(1) recurrent state
)

SMOKE = CONFIG.replace(
    num_layers=2,
    d_model=128,
    d_ff=256,
    vocab_size=512,
    rwkv_head_dim=32,
    rwkv_decay_lora=16,
    ssm_chunk=8,
    param_dtype="float32",
    dtype="float32",
)
