from repro_torch.core.precision import (  # noqa: F401
    PrecisionPolicy,
    init_scale_state,
    scale_loss,
    unscale_and_check,
)
