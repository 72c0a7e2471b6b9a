"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256; every 5th layer is a gated cross-attention layer over (stubbed)
ViT patch embeddings. [hf:meta-llama/Llama-3.2-11B-Vision]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128_256,
    cross_attn_every=5,
    vision_dim=1280,
    vision_tokens=1601,
    rope_theta=500_000.0,
    supports_long_context=False,  # full attention
)

SMOKE = CONFIG.replace(
    num_layers=2,
    cross_attn_every=2,  # 1 self + 1 cross layer
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    vision_dim=64,
    vision_tokens=16,
    param_dtype="float32",
    dtype="float32",
)
