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
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _gather_band(pages: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """(N, page, Kv, hd) pool -> (B, P * page, Kv, hd) f32 band."""
    B, P = tables.shape
    page, Kv, hd = pages.shape[1:]
    return pages[tables.long()].reshape(B, P * page, Kv, hd).float()


def paged_attention_plain(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    window: int = 0,
) -> torch.Tensor:
    """Returns (B, Kv, G, hd). Query position is ``lengths - 1`` per slot."""
    k = _gather_band(k_pages, tables)
    v = _gather_band(v_pages, tables)
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
) -> torch.Tensor:
    """Chunked-prefill sibling of :func:`paged_attention_plain`: row t of a
    chunk sits at ``start + t`` and sees ``kpos <= start + t`` (the chunk's
    own KV was written to the pool before this runs). Returns
    (B, T, Kv, G, hd); rows ``t >= q_len`` are garbage by contract."""
    T = q.shape[1]
    k = _gather_band(k_pages, tables)
    v = _gather_band(v_pages, tables)
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
