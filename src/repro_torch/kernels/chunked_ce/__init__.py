from repro_torch.kernels.chunked_ce.ops import chunked_ce  # noqa: F401
from repro_torch.kernels.chunked_ce.ref import chunked_ce_plain  # noqa: F401
