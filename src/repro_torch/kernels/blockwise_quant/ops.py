"""Blockwise codecs: flatten, zero-pad, then the CUDA kernel or its plain
version. The dynamic 8-bit codec of the low-bit optimizers (K8) first, then
the activation stash's symmetric int8 / fp8 codec (K7).

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

The stash codec (``stash_quantize`` / ``stash_dequantize``, counterparts of
the JAX ops of the same names) pads only to a multiple of ``STASH_BLOCK`` =
256 and keeps JAX's layout, codes ``(nblocks, 256)`` and scales
``(nblocks,)``. A CUDA tensor launches K7a / K7b, a CPU tensor runs
``kernels.paged_attention.quant.kv_quantize`` / ``kv_dequantize``, with
the same bits. JAX's ``backend=`` argument and its ``fused_codec_backend``
have no counterpart: the device decides.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import on_cuda
from repro_torch.kernels.blockwise_quant import cuda
from repro_torch.kernels.blockwise_quant.ref import BLOCK, dequantize_ref, quantize_ref
from repro_torch.kernels.paged_attention.quant import _QUANT, kv_dequantize, kv_quantize

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


# ------------------------------------------------------ activation stash
STASH_BLOCK = BLOCK


def stash_padded_size(n: int) -> int:
    """Values after zero-padding ``n`` to a multiple of STASH_BLOCK."""
    return (n + STASH_BLOCK - 1) // STASH_BLOCK * STASH_BLOCK


def stash_storage_dtype(storage: str) -> torch.dtype:
    if storage not in _QUANT:
        raise ValueError(f"stash storage {storage!r} not in {tuple(_QUANT)}")
    return _QUANT[storage][0]


def stash_quantize(
    x: torch.Tensor, storage: str = "int8",
    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One stash tensor -> (codes (nblocks, 256) int8 / fp8, scales
    (nblocks,) f32). Pad values quantize to zeros (a block of pad alone gets
    scale 0). With ``out`` = (codes, scales), the result is written there in
    place (on the card, by K7a itself) and ``out`` is returned."""
    sdt = stash_storage_dtype(storage)
    n = x.numel()
    flat = x.reshape(-1)
    padded = stash_padded_size(n)
    if padded != n:
        flat = F.pad(flat, (0, padded - n))
    if on_cuda(flat, "stash quantize"):
        codes, scales = out if out is not None else (None, None)
        return cuda.stash_quantize_cuda(flat.contiguous(), storage, codes, scales)
    codes, scales = kv_quantize(flat.view(-1, STASH_BLOCK), sdt)
    if out is None:
        return codes, scales
    out[0].copy_(codes)
    out[1].copy_(scales)
    return out


def stash_dequantize(
    codes: torch.Tensor, scales: torch.Tensor, shape: Sequence[int], dtype,
) -> torch.Tensor:
    """The inverse of :func:`stash_quantize`: a ``shape`` tensor of ``dtype``
    (the pad tail dropped)."""
    n = 1
    for d in shape:
        n *= int(d)
    if on_cuda(codes, "stash dequantize"):
        flat = cuda.stash_dequantize_cuda(codes, scales, dtype).view(-1)
    else:
        flat = kv_dequantize(codes, scales, dtype).reshape(-1)
    return flat[:n].view(tuple(shape))
