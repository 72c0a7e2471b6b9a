"""minicpm3-4b [dense] — 62L d_model=2560 40H d_ff=6400 vocab=73448 with MLA
(multi-head latent attention: compressed KV cache). [hf:openbmb/MiniCPM3-4B]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm3-4b",
    family="dense",
    source="hf:openbmb/MiniCPM3-4B",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    d_ff=6400,
    vocab_size=73_448,
    use_mla=True,
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_head_dim=64,
    qk_rope_head_dim=32,
    v_head_dim=64,
    head_dim=64,
    supports_long_context=False,  # pure full attention
)

SMOKE = CONFIG.replace(
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    d_ff=512,
    vocab_size=512,
    q_lora_rank=64,
    kv_lora_rank=32,
    qk_nope_head_dim=32,
    qk_rope_head_dim=16,
    v_head_dim=32,
    head_dim=32,
    param_dtype="float32",
    dtype="float32",
)
