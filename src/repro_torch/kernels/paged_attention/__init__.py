from repro_torch.kernels.paged_attention.ops import (  # noqa: F401
    paged_attention,
    paged_prefill_attention,
)
from repro_torch.kernels.paged_attention.ref import (  # noqa: F401
    paged_attention_plain,
    paged_prefill_attention_plain,
)
