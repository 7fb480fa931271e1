from repro_torch.models.lm import (  # noqa: F401
    LM,
    decode_step,
    decode_step_paged,
    encode,
    forward,
    forward_hidden,
    init_decode_state,
    init_paged_state,
    init_params,
    loss_fn,
    masked_token_ce,
    pipeline_fns,
    pipeline_shared,
    prefill,
    prefill_chunk_paged,
    verify_step_paged,
)
from repro_torch.models.runtime import Runtime  # noqa: F401
