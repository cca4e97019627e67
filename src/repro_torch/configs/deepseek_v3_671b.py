"""deepseek-v3-671b — MoE with MLA, 1 shared + 256 routed experts (top-8),
multi-token prediction [arXiv:2412.19437].

61L, d_model=7168, 128H (MLA latent cache), routed expert d_ff=2048,
vocab=129280. First 3 layers are dense MLP (d_ff=18432).
"""
from repro_torch.configs.base import (MLAConfig, MoEConfig, ModelConfig,
                                      register)

CONFIG = register(ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=2048,                     # routed-expert hidden size (as assigned)
    vocab_size=129280,
    head_dim=128,
    moe=MoEConfig(num_experts=256, top_k=8, d_expert=2048,
                  num_shared_experts=1, capacity_factor=1.25,
                  first_k_dense=3, dense_d_ff=18432),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    num_mtp_modules=1,
    rope_theta=10_000.0,
    supports_long_context=False,
    source="arXiv:2412.19437",
))
