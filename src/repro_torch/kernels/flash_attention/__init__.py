from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    flash_attention_bwd_plain,
    flash_attention_fwd_plain,
)
