"""bert-base [encoder] — the paper's OWN base model (WRENCH noisy-finetuning
experiments, Sec. 4.1): 12L d_model=768 12H d_ff=3072 vocab=30522, encoder-
only classifier. [arXiv:1810.04805 / paper Sec. 4.1]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="bert-base",
    family="encoder",
    source="paper Sec 4.1 / arXiv:1810.04805",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=30_522,
    norm="layernorm",
    act="gelu",
    mlp_type="mlp",
    use_rope=False,
    pos_embed="learned",
    max_position=512,
    num_labels=4,
    supports_long_context=False,
)

SMOKE = CONFIG.replace(
    num_layers=2,
    d_model=128,
    num_heads=2,
    num_kv_heads=2,
    head_dim=64,
    d_ff=256,
    vocab_size=512,
    max_position=128,
    num_labels=4,
    param_dtype="float32",
    dtype="float32",
)
