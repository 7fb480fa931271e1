"""Plain PyTorch versions of the two paged-attention kernels.

Counterparts of ``repro.kernels.paged_attention.ref``: gather each request's
whole ``(P * page)`` key band through its block table, mask by absolute
position, and take an f32 softmax. They are what ``ops`` runs for CPU
tensors, and what ``chip_smoke.py`` holds each CUDA kernel against.

Layouts (as in the JAX package):
  q        (B, Kv, G, hd)      decode; pre-scaled by hd**-0.5, roped at L-1
  q        (B, T, Kv, G, hd)   prefill; row t roped at start + t
  k_pages  (N, page, Kv, hd)   page 0 is the reserved null page
  tables   (B, P) int32        page ids per request (padding entries -> 0)
  lengths  (B,) int32          valid tokens per request (incl. current one)
  start    (B,) int32          absolute position of a chunk's row 0
  q_len    (B,) int32          valid rows of a chunk (rows >= q_len: garbage)
  k_scale  (N, page, Kv) f32   quantized pools only: one scale per (page slot,
  v_scale                      kv head), gathered through the same tables

Quantized pools (int8 / fp8 codes) are dequantized in the gathered band, in
f32, as ``code * scale`` (the JAX oracle's ``_gather_band``); no dequantized
pool is made. Without scales the pools are read as they are.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _gather_band(pages: torch.Tensor, tables: torch.Tensor,
                 scale: Optional[torch.Tensor]) -> torch.Tensor:
    """(N, page, Kv, hd) pool -> (B, P * page, Kv, hd) f32 band, dequantized
    when ``scale`` (N, page, Kv) is given."""
    B, P = tables.shape
    page, Kv, hd = pages.shape[1:]
    idx = tables.long()
    band = pages[idx].reshape(B, P * page, Kv, hd).float()
    if scale is not None:
        band = band * scale[idx].reshape(B, P * page, Kv, 1).float()
    return band


def _scales(k_scale, v_scale):
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")


def paged_attention_plain(
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
    """Returns (B, Kv, G, hd). Query position is ``lengths - 1`` per slot."""
    _scales(k_scale, v_scale)
    k = _gather_band(k_pages, tables, k_scale)
    v = _gather_band(v_pages, tables, v_scale)
    scores = torch.einsum("bkgh,bskh->bkgs", q.float(), k)
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]       # (1, S)
    t = (lengths.long() - 1)[:, None]                                # query pos
    valid = kpos <= t
    if window > 0:
        valid = valid & (kpos > t - window)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgs,bskh->bkgh", w, v).to(q.dtype)


def paged_prefill_attention_plain(
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
    """Chunked-prefill sibling of :func:`paged_attention_plain`: row t of a
    chunk sits at ``start + t`` and sees ``kpos <= start + t`` (the chunk's
    own KV was written to the pool before this runs). Returns
    (B, T, Kv, G, hd); rows ``t >= q_len`` are garbage by contract."""
    _scales(k_scale, v_scale)
    T = q.shape[1]
    k = _gather_band(k_pages, tables, k_scale)
    v = _gather_band(v_pages, tables, v_scale)
    scores = torch.einsum("btkgh,bskh->bkgts", q.float(), k)        # (B,Kv,G,T,S)
    kpos = torch.arange(k.shape[1], device=q.device)[None, None, :]
    qpos = (start.long()[:, None] + torch.arange(T, device=q.device)[None, :])[
        :, :, None
    ]                                                                 # (B, T, 1)
    valid = kpos <= qpos
    if window > 0:
        valid = valid & (kpos > qpos - window)
    scores = torch.where(valid[:, None, None, :, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgts,bskh->btkgh", w, v).to(q.dtype)
