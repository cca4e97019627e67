"""mamba2-1.3b — attention-free SSM with state-space duality (SSD)
[arXiv:2405.21060].

48L, d_model=2048, vocab=50280, ssm_state=128. d_inner = 2*d_model = 4096,
head_dim P=64 => 64 SSD heads. Sub-quadratic: runs long_500k decode.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    head_dim=64,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk_size=256,
                  conv_width=4),
    tie_embeddings=True,
    supports_long_context=True,
    source="arXiv:2405.21060",
))
