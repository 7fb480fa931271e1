from repro_torch.models.lm import (  # noqa: F401
    LM,
    decode_step_paged,
    forward,
    forward_hidden,
    init_paged_state,
    init_params,
    loss_fn,
    masked_token_ce,
    prefill_chunk_paged,
)
from repro_torch.models.runtime import Runtime  # noqa: F401
