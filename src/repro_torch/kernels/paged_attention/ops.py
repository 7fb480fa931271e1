"""Public paged-attention ops: the CUDA kernel for a CUDA tensor, the plain
PyTorch version for a CPU tensor.

The choice goes by the tensor's device and nothing else: there is no switch,
environment variable or fallback that runs the plain version on the card. A
CUDA tensor launches the kernel (``cuda.py``) or raises. Layouts are those
of ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention import cuda
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_plain,
    paged_prefill_attention_plain,
)


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cuda", "cpu"):
        return t.device.type
    raise ValueError(f"paged attention runs on cuda or cpu, not {t.device}")


def paged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    window: int = 0,
) -> torch.Tensor:
    """Decode attention. q (B, Kv, G, hd) pre-scaled -> (B, Kv, G, hd)."""
    if _route(q) == "cuda":
        return cuda.paged_decode_attention_cuda(
            q, k_pages, v_pages, tables, lengths, window=window
        )
    return paged_attention_plain(q, k_pages, v_pages, tables, lengths, window=window)


def paged_prefill_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    tables: torch.Tensor,
    start: torch.Tensor,
    q_len: torch.Tensor,
    *,
    window: int = 0,
) -> torch.Tensor:
    """Chunked-prefill attention. q (B, T, Kv, G, hd) -> (B, T, Kv, G, hd)."""
    if _route(q) == "cuda":
        return cuda.paged_prefill_attention_cuda(
            q, k_pages, v_pages, tables, start, q_len, window=window
        )
    return paged_prefill_attention_plain(
        q, k_pages, v_pages, tables, start, q_len, window=window
    )
