from repro_torch.optim.base import (  # noqa: F401
    Optimizer,
    Schedule,
    apply_updates,
    clip_by_global_norm,
    global_norm,
)
from repro_torch.optim.lowbit import adam8bit, state_bytes  # noqa: F401
from repro_torch.optim.optimizers import adamw, get, lamb, lars, sgd  # noqa: F401
from repro_torch.optim.lowbit4 import adam4bit  # noqa: F401
from repro_torch.optim.onebit import onebit_adam  # noqa: F401
