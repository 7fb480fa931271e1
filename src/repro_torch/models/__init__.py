from repro_torch.models.lm import (  # noqa: F401
    LM,
    decode_step_paged,
    init_paged_state,
    init_params,
    prefill_chunk_paged,
)
from repro_torch.models.runtime import Runtime  # noqa: F401
