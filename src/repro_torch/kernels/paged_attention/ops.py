"""Public paged-attention ops: the CUDA kernel for a CUDA tensor, the plain
PyTorch version for a CPU tensor.

The choice goes by the tensor's device and nothing else: there is no switch,
environment variable or fallback that runs the plain version on the card. A
CUDA tensor launches the kernel (``cuda.py``) or raises. Layouts are those
of ``ref.py``. A quantized pool (int8 / fp8 codes) comes with ``k_scale`` /
``v_scale`` (N, page, Kv) f32, which both paths dequantize inside the gather,
as the JAX package's ops pass them to its kernels and oracles.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import on_cuda
from repro_torch.kernels.paged_attention import cuda
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_plain,
    paged_prefill_attention_plain,
)


def paged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    window: int = 0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode attention. q (B, Kv, G, hd) pre-scaled -> (B, Kv, G, hd)."""
    if on_cuda(q, "paged attention"):
        return cuda.paged_decode_attention_cuda(
            q, k_pages, v_pages, tables, lengths, window=window,
            k_scale=k_scale, v_scale=v_scale,
        )
    return paged_attention_plain(q, k_pages, v_pages, tables, lengths, window=window,
                                 k_scale=k_scale, v_scale=v_scale)


def paged_prefill_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    tables: torch.Tensor,
    start: torch.Tensor,
    q_len: torch.Tensor,
    *,
    window: int = 0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Chunked-prefill attention. q (B, T, Kv, G, hd) -> (B, T, Kv, G, hd)."""
    if on_cuda(q, "paged attention"):
        return cuda.paged_prefill_attention_cuda(
            q, k_pages, v_pages, tables, start, q_len, window=window,
            k_scale=k_scale, v_scale=v_scale,
        )
    return paged_prefill_attention_plain(
        q, k_pages, v_pages, tables, start, q_len, window=window,
        k_scale=k_scale, v_scale=v_scale,
    )
