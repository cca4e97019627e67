from repro_torch.checkpoint.checkpointer import (  # noqa: F401
    checkpoint_step,
    load_checkpoint,
    load_train_state,
    save_checkpoint,
)
