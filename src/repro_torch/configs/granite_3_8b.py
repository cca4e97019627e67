"""granite-3-8b — dense GQA decoder [hf:ibm-granite/granite-3.0-2b-base].

40L, d_model=4096, 32H GQA kv=8, d_ff=12800, vocab=49155.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    rope_theta=10_000_000.0,
    tie_embeddings=True,
    supports_long_context=False,
    source="hf:ibm-granite/granite-3.0-2b-base",
))
