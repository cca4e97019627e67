"""minicpm3-4b — dense decoder with Multi-head Latent Attention (MLA)
[hf:openbmb/MiniCPM3-4B].

62L, d_model=2560, 40H (kv=40 logical; MLA caches a 256-dim latent + 32-dim
rope key), d_ff=6400, vocab=73448.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    head_dim=64,
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_head_dim=64,
                  qk_rope_head_dim=32, v_head_dim=64),
    tie_embeddings=True,
    supports_long_context=False,
    source="hf:openbmb/MiniCPM3-4B",
))
