from repro_torch.ckpt.checkpoint import (
    CheckpointManager,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
    to_tensor,
)

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint",
           "latest_checkpoint", "to_tensor"]
