from repro_torch.serve.engine import (  # noqa: F401
    Capacity,
    EngineConfig,
    ReplicatedServeEngine,
    ServeEngine,
    paged_supported,
)
from repro_torch.serve.pool import PagePool, PoolExhausted  # noqa: F401
from repro_torch.serve.prefix import PrefixCache  # noqa: F401
from repro_torch.serve.sampling import SamplingPolicy  # noqa: F401
from repro_torch.serve.scheduler import (  # noqa: F401
    QueueFull,
    Request,
    Scheduler,
)
from repro_torch.serve.spec import (  # noqa: F401
    DRAFTER_KINDS,
    ngram_draft,
    paired_drafter_cfg,
)
