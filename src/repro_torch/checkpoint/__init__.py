from repro_torch.checkpoint.convert import (  # noqa: F401
    params_from_jax,
    params_to_numpy,
    state_from_jax,
    state_to_numpy,
    unflatten,
)
