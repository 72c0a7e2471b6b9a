"""gemma3-1b [dense] — 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144,
5:1 local:global sliding-window attention, 128k context.
[hf:google/gemma-3-1b-pt]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    source="hf:google/gemma-3-1b-pt",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262_144,
    attn_pattern=("local", "local", "local", "local", "local", "global"),
    sliding_window=512,
    rope_theta=1_000_000.0,
    act="gelu",
    supports_long_context=True,  # 5:1 sliding-window layers
)

SMOKE = CONFIG.replace(
    num_layers=2,
    d_model=256,
    num_heads=2,
    num_kv_heads=1,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    sliding_window=8,
    attn_pattern=("local", "global"),
    param_dtype="float32",
    dtype="float32",
)
