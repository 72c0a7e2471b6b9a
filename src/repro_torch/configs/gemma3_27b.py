"""gemma3-27b [dense] — 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144, 5:1 local:global, 128k. [hf:google/gemma-3-1b-pt (family card)]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b",
    family="dense",
    source="hf:google/gemma-3-1b-pt",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262_144,
    attn_pattern=("local", "local", "local", "local", "local", "global"),
    sliding_window=1024,
    rope_theta=1_000_000.0,
    act="gelu",
    supports_long_context=True,
)

SMOKE = CONFIG.replace(
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    sliding_window=8,
    attn_pattern=("local", "global"),
    param_dtype="float32",
    dtype="float32",
)
