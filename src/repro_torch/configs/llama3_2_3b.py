"""llama3.2-3b — small Llama-3 dense GQA decoder [hf:meta-llama/Llama-3.2-1B].

28L, d_model=3072, 24H GQA kv=8, d_ff=8192, vocab=128256, tied embeddings.

long_500k: the base config is full attention; the dry-run uses a documented
sliding-window variant (window=8192) so this dense arch can also exercise the
long-context decode shape (beyond-paper addition, see DESIGN.md §6).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama3.2-3b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500_000.0,
    tie_embeddings=True,
    supports_long_context=False,   # variant with sliding_window=8192 runs it
    source="hf:meta-llama/Llama-3.2-1B",
))

LONG_CONTEXT_WINDOW = 8192
