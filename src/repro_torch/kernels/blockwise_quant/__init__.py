from repro_torch.kernels.blockwise_quant.ops import (  # noqa: F401
    BLOCK,
    dequantize,
    padded_size,
    quantize,
)
from repro_torch.kernels.blockwise_quant.ref import (  # noqa: F401
    dequantize_ref,
    dynamic_map,
    quantize_ref,
)
