from repro_torch.kernels.rmsnorm.ops import rmsnorm  # noqa: F401
from repro_torch.kernels.rmsnorm.ref import (  # noqa: F401
    rmsnorm_bwd_plain,
    rmsnorm_plain,
)
