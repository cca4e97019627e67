"""Plain float32 references, one module per model family. They import
plain PyTorch only: no kernel, cache or batching, and nothing of the
program under test."""
