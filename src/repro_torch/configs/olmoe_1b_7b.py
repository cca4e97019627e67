"""olmoe-1b-7b — MoE with 64 experts, top-8 routing [arXiv:2409.02060].

16L, d_model=2048, 16H (kv=16), per-expert d_ff=1024, vocab=50304.
~1B active / ~7B total parameters.
"""
from repro_torch.configs.base import MoEConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    moe=MoEConfig(num_experts=64, top_k=8, d_expert=1024,
                  num_shared_experts=0, capacity_factor=1.25),
    supports_long_context=False,
    source="arXiv:2409.02060",
))
