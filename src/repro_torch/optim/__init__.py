from repro_torch.optim.adamw import (
    OptState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    lr_schedule,
)
from repro_torch.optim.compress import (
    compress_gradient,
    decompress_gradient,
    ef_state_init,
)

__all__ = [k for k in dir() if not k.startswith("_")]
