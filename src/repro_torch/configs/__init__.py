from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    INPUT_SHAPES,
    ShapeSpec,
    pad_to,
    reduced,
)
from repro_torch.configs.registry import (  # noqa: F401
    ARCHITECTURES,
    ASSIGNED,
    SURVEY_DEMO,
    get_config,
    get_reduced,
    get_shape,
)
