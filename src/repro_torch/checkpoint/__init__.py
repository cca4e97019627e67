from repro_torch.checkpoint.checkpointer import load_checkpoint  # noqa: F401
