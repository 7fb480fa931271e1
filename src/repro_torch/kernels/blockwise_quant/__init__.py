from repro_torch.kernels.blockwise_quant.ops import (  # noqa: F401
    BLOCK,
    STASH_BLOCK,
    dequantize,
    padded_size,
    quantize,
    stash_dequantize,
    stash_padded_size,
    stash_quantize,
)
from repro_torch.kernels.blockwise_quant.ref import (  # noqa: F401
    dequantize_ref,
    dynamic_map,
    quantize_ref,
)
