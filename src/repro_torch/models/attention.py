"""GQA attention over the paged KV pool: the paged halves of
``repro.models.attention``.

The page pools are updated in place (JAX returned new pools and donated the
old buffers; here the write lands in the caller's tensor). The order is the
JAX package's: the new K/V rows are written to their block-table pages
first, then every query row attends through the paged op, so in-chunk
causality and the cached prefix are the same absolute-position mask.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.paged_attention import (
    paged_attention,
    paged_prefill_attention,
)
from repro_torch.models.layers import dense_init, frozen, rope_apply


class Attention(nn.Module):
    """Projection weights, (d_in, d_out) as in the JAX tree: ``x @ w``."""

    def __init__(self, wq, wk, wv, wo):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = (frozen(w) for w in (wq, wk, wv, wo))

    @classmethod
    def init(cls, gen, d: int, n_heads: int, n_kv: int, head_dim: int, dtype):
        return cls(
            dense_init(gen, d, n_heads * head_dim, dtype=dtype),
            dense_init(gen, d, n_kv * head_dim, dtype=dtype),
            dense_init(gen, d, n_kv * head_dim, dtype=dtype),
            dense_init(gen, n_heads * head_dim, d, dtype=dtype),
        )


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, hd))


def check_kv_dtype(kv_dtype: str) -> None:
    if kv_dtype not in ("", "bf16", "native"):
        raise NotImplementedError(
            f"kv_dtype {kv_dtype!r}: quantized KV pools are ROADMAP queue 1, "
            "item 'quantized KV' (the int8/fp8 scale path of K5/K6)"
        )


def attention_prefill_paged(
    p: Attention,
    x: torch.Tensor,
    kp: torch.Tensor,
    vp: torch.Tensor,
    tables: torch.Tensor,
    start: torch.Tensor,
    q_len: torch.Tensor,
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    theta: float,
    window: int = 0,
) -> torch.Tensor:
    """One prefill chunk per slot against the paged pool (written in place).

    x: (B, T, d); kp/vp: (N, page, Kv, hd); tables: (B, P) int32; start:
    (B,) absolute position of x[:, 0]; q_len: (B,) valid rows. Rows at or
    beyond q_len write the null page and their output is zeroed. Returns
    (B, T, d)."""
    B, T, _ = x.shape
    dtype = x.dtype
    G = n_heads // n_kv
    page = kp.shape[1]
    P = tables.shape[1]

    t_idx = torch.arange(T, dtype=torch.int32, device=x.device)
    pos = start[:, None] + t_idx[None, :]                                  # (B, T)
    q = rope_apply(_split_heads(x @ p.wq.to(dtype), n_heads, head_dim), pos, theta)
    k_new = rope_apply(_split_heads(x @ p.wk.to(dtype), n_kv, head_dim), pos, theta)
    v_new = _split_heads(x @ p.wv.to(dtype), n_kv, head_dim)

    valid = t_idx[None, :] < q_len[:, None]
    page_idx = pos // page
    ok = valid & (page_idx < P)
    pid = torch.where(
        ok,
        torch.take_along_dim(tables, page_idx.clamp(0, P - 1).long(), dim=1),
        0,
    ).long()
    slot = torch.where(ok, pos % page, 0).long()
    # invalid rows all land on (0, 0) of the null page: duplicates there are
    # harmless, it is never attended unmasked
    kp[pid, slot] = k_new
    vp[pid, slot] = v_new

    q = q.reshape(B, T, n_kv, G, head_dim) * (head_dim ** -0.5)
    out = paged_prefill_attention(q, kp, vp, tables, start, q_len, window=window)
    out = torch.where(valid[:, :, None, None, None], out, 0)
    out = out.to(dtype).reshape(B, T, n_heads * head_dim)
    return out @ p.wo.to(dtype)


def attention_decode_paged(
    p: Attention,
    x: torch.Tensor,
    kp: torch.Tensor,
    vp: torch.Tensor,
    tables: torch.Tensor,
    lengths: torch.Tensor,
    active: torch.Tensor,
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    theta: float,
    window: int = 0,
) -> torch.Tensor:
    """One decode token per slot against the paged pool (written in place).

    x: (B, 1, d); lengths: (B,) int32 tokens already cached per slot (the
    new token's position); active: (B,) bool — inactive slots write the null
    page and their output is garbage by contract. Returns (B, 1, d)."""
    B = x.shape[0]
    dtype = x.dtype
    G = n_heads // n_kv
    page = kp.shape[1]
    P = tables.shape[1]

    pos = lengths[:, None]                                                 # (B, 1)
    q = rope_apply(_split_heads(x @ p.wq.to(dtype), n_heads, head_dim), pos, theta)
    k_new = rope_apply(_split_heads(x @ p.wk.to(dtype), n_kv, head_dim), pos, theta)
    v_new = _split_heads(x @ p.wv.to(dtype), n_kv, head_dim)

    page_idx = lengths // page
    ok = active & (page_idx < P)              # horizon overflow -> null page
    page_ids = torch.take_along_dim(
        tables, page_idx.clamp(0, P - 1).long()[:, None], dim=1
    )[:, 0]
    page_ids = torch.where(ok, page_ids, 0).long()
    slot = torch.where(ok, lengths % page, 0).long()
    kp[page_ids, slot] = k_new[:, 0]
    vp[page_ids, slot] = v_new[:, 0]

    q = q.reshape(B, n_kv, G, head_dim) * (head_dim ** -0.5)
    out = paged_attention(q, kp, vp, tables, lengths + 1, window=window)
    out = out.to(dtype).reshape(B, 1, n_heads * head_dim)
    return out @ p.wo.to(dtype)
