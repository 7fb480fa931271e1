from repro_torch.optim.base import (  # noqa: F401
    Optimizer,
    Schedule,
    apply_updates,
    clip_by_global_norm,
    global_norm,
)
from repro_torch.optim.optimizers import adamw, get, lamb, lars, sgd  # noqa: F401
