"""whisper-small [audio] — enc-dec, 12L+12L d_model=768 12H d_ff=3072
vocab=51865. Conv/mel frontend is a STUB: the batch carries precomputed
frame embeddings ``frames`` (B, 1500, 768). [arXiv:2212.04356]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    source="arXiv:2212.04356",
    num_layers=12,
    encoder_layers=12,
    is_encoder_decoder=True,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51_865,
    encoder_seq=1500,
    norm="layernorm",
    act="gelu",
    mlp_type="mlp",
    use_rope=False,
    pos_embed="learned",
    max_position=32_768,  # shape exercise; real whisper decodes <= 448
    supports_long_context=False,  # enc-dec, full attention
)

SMOKE = CONFIG.replace(
    num_layers=2,
    encoder_layers=2,
    d_model=128,
    num_heads=2,
    num_kv_heads=2,
    head_dim=64,
    d_ff=256,
    vocab_size=512,
    encoder_seq=32,
    max_position=256,
    param_dtype="float32",
    dtype="float32",
)
