"""Blockwise dynamic 8-bit codec: flatten, zero-pad, then K8 or its plain
version.

Counterpart of ``repro.kernels.blockwise_quant.ops.quantize`` /
``dequantize``. Inputs are flattened and zero-padded to a multiple of
``BLOCK * TILE_ROWS`` = 16,384 values, exactly as the reference pads them,
so the codes and scales have the reference's shapes — the shapes a
checkpoint of low-bit optimizer state carries. Pad values quantize to the
code of 0.0 (a block of pad alone gets scale 0) and dequantize to exact
zeros.

The JAX ops take ``backend="ref"|"pallas"``, two paths that give the same
codes bitwise. Here the choice goes by the tensor's device and nothing
else: a CUDA tensor launches K8a / K8b (``cuda.py``) or raises, a CPU
tensor runs the plain version (``ref.py``). Both give the same bits.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import on_cuda
from repro_torch.kernels.blockwise_quant import cuda
from repro_torch.kernels.blockwise_quant.ref import BLOCK, dequantize_ref, quantize_ref

TILE_ROWS = 64                    # the reference's tile of quantization blocks


def padded_size(n: int) -> int:
    """Values after zero-padding ``n`` to a multiple of BLOCK * TILE_ROWS."""
    unit = BLOCK * TILE_ROWS
    return (n + unit - 1) // unit * unit


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Flattens, zero-pads, quantizes. Returns (codes uint8 (padded,),
    scales f32 (padded / 256,), original size)."""
    n = x.numel()
    flat = x.reshape(-1).float()
    padded = padded_size(n)
    if padded != n:
        flat = F.pad(flat, (0, padded - n))
    if on_cuda(flat, "blockwise quantize"):
        codes, scales = cuda.quantize_cuda(flat.contiguous())
    else:
        codes, scales = quantize_ref(flat)
    return codes, scales, n


def dequantize(
    codes: torch.Tensor, scales: torch.Tensor, n: int, shape: Sequence[int]
) -> torch.Tensor:
    """f32 values of ``shape`` (``n`` of them) from codes and scales."""
    if on_cuda(codes, "blockwise dequantize"):
        flat = cuda.dequantize_cuda(codes, scales)
    else:
        flat = dequantize_ref(codes, scales)
    return flat[:n].reshape(shape)
