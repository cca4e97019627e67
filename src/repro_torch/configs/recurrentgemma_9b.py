"""recurrentgemma-9b — Griffin hybrid: RG-LRU + local attention, 1:2
[arXiv:2402.19427].

38L, d_model=4096, 16H MQA (kv=1), d_ff=12288, vocab=256000. Pattern is
(rglru, rglru, attn) repeating; local attention window 2048. Bounded state
=> runs long_500k decode.
"""
from repro_torch.configs.base import ModelConfig, RGLRUConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    rglru=RGLRUConfig(lru_width=4096, window=2048,
                      pattern=("rglru", "rglru", "attn"), conv_width=4),
    tie_embeddings=True,
    supports_long_context=True,
    source="arXiv:2402.19427",
))
