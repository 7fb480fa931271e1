"""Symmetric int8 / fp8 row quantization: the plain version of the stash
codec (K7) and the quantized KV pool's codec.

Counterpart of ``repro.kernels.paged_attention.quant``, op for op in f32.
Each row (the last axis) gets one f32 scale, ``absmax / code_max`` (127 for
int8, 448 for fp8-e4m3fn); codes are ``round_half_even(clip(x / safe))``
for int8 or the round-to-nearest-even cast to fp8, where ``safe`` is the
scale, or 1 for an all-zero row (scale 0, codes 0: it dequantizes to exact
zeros). Dequantization is the f32 product ``code * scale`` and one cast.

Both divisions are IEEE divisions of two tensors (PyTorch computes those
correctly rounded on the CPU and on the card), so the codes and scales equal
the JAX package's eager ``kv_quantize`` bit for bit. (XLA's jitted division
may differ from the eager one by an ulp in the scale: the port follows the
eager call, which is what the JAX host-driven pipeline runner executes.)

The stash ops (``kernels.blockwise_quant.ops.stash_quantize``) run these on
CPU tensors and the hand-written K7a / K7b on CUDA tensors. The serving
engine's quantized pools use ``kv_quantize`` as their write path on both
devices (``models.attention``: each new K/V row quantized once, codes and
scale written at the same page slot), and K5 / K6 dequantize inside their
gathers; ``kv_token_bytes`` prices the pool.
"""
from __future__ import annotations

from typing import Tuple

import torch

# storage dtype and the largest code magnitude of each quantized dtype
_QUANT = {
    "int8": (torch.int8, 127.0),
    "fp8": (torch.float8_e4m3fn, 448.0),
}
KV_DTYPES = ("bf16", "int8", "fp8")
SCALE_BYTES = 4  # one f32 scale per row


def normalize_kv_dtype(kv_dtype: str) -> str:
    """Canonical pool-dtype name: '' means native (stored at the compute
    dtype; 'bf16' and 'native' are its other spellings)."""
    if kv_dtype in ("", "native", "bf16"):
        return ""
    if kv_dtype not in _QUANT:
        raise ValueError(f"kv_dtype {kv_dtype!r} not in {('bf16',) + tuple(_QUANT)}")
    return kv_dtype


def is_quantized(kv_dtype: str) -> bool:
    return normalize_kv_dtype(kv_dtype) != ""


def kv_storage_dtype(kv_dtype: str, native) -> torch.dtype:
    kv_dtype = normalize_kv_dtype(kv_dtype)
    return _QUANT[kv_dtype][0] if kv_dtype else native


def code_max(storage_dtype: torch.dtype) -> float:
    for dt, cmax in _QUANT.values():
        if dt == storage_dtype:
            return cmax
    raise ValueError(f"not a quantized storage dtype: {storage_dtype}")


def kv_quantize(
    x: torch.Tensor, storage_dtype: torch.dtype
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows (..., n) -> (codes (..., n) ``storage_dtype``, scales (...,) f32)."""
    cmax = code_max(storage_dtype)
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    # divide by a tensor: PyTorch's CUDA kernel turns division by a Python
    # scalar into a product with its reciprocal, which is not IEEE division
    scale = absmax / torch.full_like(absmax, cmax)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))[..., None]
    scaled = torch.clamp(xf / safe, -cmax, cmax)
    if storage_dtype == torch.int8:
        return torch.round(scaled).to(torch.int8), scale
    return scaled.to(storage_dtype), scale


def kv_dequantize(
    codes: torch.Tensor, scales: torch.Tensor, dtype=torch.float32
) -> torch.Tensor:
    """codes (..., n), scales (...,) f32 -> (..., n) ``dtype``."""
    return (codes.float() * scales[..., None].float()).to(dtype)


def kv_token_bytes(n_kv: int, head_dim: int, kv_dtype: str,
                   native_itemsize: int = 2) -> int:
    """Pool bytes per cached token (K + V, and their scales when quantized);
    ``native_itemsize`` prices the unquantized pool (2 = bf16)."""
    if is_quantized(kv_dtype):
        itemsize = kv_storage_dtype(kv_dtype, None).itemsize
        return 2 * n_kv * (head_dim * itemsize + SCALE_BYTES)
    return 2 * n_kv * head_dim * native_itemsize
