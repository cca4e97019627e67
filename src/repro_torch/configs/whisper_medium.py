"""whisper-medium — encoder-decoder ASR backbone [arXiv:2212.04356].

24 enc + 24 dec layers, d_model=1024, 16 heads (MHA, kv=16), d_ff=4096,
vocab=51865. The mel-spectrogram + conv frontend is a STUB: ``input_specs``
feeds precomputed frame embeddings of shape (batch, 1500, d_model).

Adaptation note: real Whisper uses learned absolute positions capped at 448
decoder tokens; we use RoPE in the decoder so the assigned decode shapes lower
structurally, and record the architectural cap in ``max_decode_kv``.
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,                 # decoder layers
    num_encoder_layers=24,
    encoder_seq_len=1500,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    qkv_bias=True,
    causal=True,
    frontend=FrontendConfig(kind="audio", num_tokens=1500, embed_dim=0),
    max_decode_kv=448,
    supports_long_context=False,
    source="arXiv:2212.04356",
))
