from repro_torch.train.loop import (  # noqa: F401
    TrainConfig,
    finish_step,
    fit,
    make_state,
    make_train_step,
)
