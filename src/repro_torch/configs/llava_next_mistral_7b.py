"""llava-next-mistral-7b — VLM, Mistral-7B backbone with anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf].

32L, d_model=4096, 32H GQA kv=8, d_ff=14336, vocab=32000. The SigLIP/CLIP
vision tower + projector is a STUB: ``input_specs`` feeds patch embeddings
(batch, n_img_tokens, d_model). AnyRes tiling => up to 5 tiles x 576 patches
= 2880 image tokens prepended to the text sequence.
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1_000_000.0,
    frontend=FrontendConfig(kind="vision", num_tokens=2880, embed_dim=0),
    supports_long_context=False,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
))
