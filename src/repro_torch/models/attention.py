"""GQA attention: the full-sequence path (training and whole-prompt
prefill), the dense ring cache and the paged serving halves of
``repro.models.attention``.

``attention_apply`` is the JAX function: q, k and v projections, RoPE, q
pre-scaled by ``hd**-0.5``, then ``flash_attention`` over the (B, S, Kv, G,
hd) layout (K1/K2 on a CUDA tensor, the plain version on a CPU tensor). It
computes the same function as the JAX banded query-chunk scan without
copying it. With ``collect_kv`` it also returns the roped k and the v that
K1 consumed, for a prefill's cache. Given ``memory`` (an encoder's output)
it is cross-attention: q from x, k and v from memory, no RoPE on either,
never causal and no window, so K1 runs at Sq != Sk. JAX's cross path is
plain jnp (its Pallas kernel only takes self-attention); K1 computes the
same function, with p kept in f32 where JAX casts the softmax to the
compute dtype before the combine (a bf16 rounding difference).
``cross_decode`` is JAX's one-token cross-attention over the cached
encoder k/v (``stack._cross_decode``), plain PyTorch as in JAX.

The dense ring cache (``init_kv_cache``, ``fill_kv_cache``,
``attention_decode``) holds ``cache_len`` rows with an explicit position
array. Position p always lives in row ``p % cache_len``, in the prefill's
fill as in every decode write, so a decode write replaces the oldest row.
(The JAX ``fill_kv_cache`` keeps the trailing rows in order instead, which
puts a decode write on a row still inside the window whenever the prompt is
longer than the ring and not a multiple of it; ROADMAP queue 3.) The
one-token dense decode is plain PyTorch, as the JAX function is plain jnp
outside any Pallas kernel; it updates the cache in place.

The page pools are updated in place (JAX returned new pools and donated the
old buffers; here the write lands in the caller's tensor). The order is the
JAX package's: the new K/V rows are written to their block-table pages
first, then every query row attends through the paged op, so in-chunk
causality and the cached prefix are the same absolute-position mask.

A quantized pool (int8 / fp8 codes, ``kv_dtype``) comes with its scale pools
``ksc`` / ``vsc`` (N, page, Kv) f32: each new K/V row is quantized once, at
write time, by ``quant.kv_quantize`` (its codes and scale depend on its own
values alone, so pool bytes do not depend on the batch), the codes and the
scale land at the same ``(pid, slot)``, and the paged op dequantizes inside
its gather (K5/K6 on the card).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import (
    paged_attention,
    paged_prefill_attention,
    quant,
)
from repro_torch.models.layers import dense_init, frozen, rope_apply

NEG_INF = -1e30
INVALID_POS = -(2**30)


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


def attention_apply(
    p: Attention,
    x: torch.Tensor,
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    theta: float,
    window: int = 0,
    causal: bool = True,
    positions: Optional[torch.Tensor] = None,
    memory: Optional[torch.Tensor] = None,
    collect_kv: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full-sequence attention (training, prefill). x: (B, S, d); positions
    (B, S), default 0..S-1. Self-attention, or with ``memory`` (B, T, d)
    cross-attention over it (no RoPE, not causal, no window: ``causal``,
    ``window`` and ``positions`` do not apply). Returns (out (B, S, d), kv):
    kv is ``{"k", "v"}`` when ``collect_kv``, else None: (B, S, Kv, hd), k
    roped, or for cross-attention memory's (B, T, Kv, hd)."""
    B, S, _ = x.shape
    dtype = x.dtype
    G = n_heads // n_kv
    src = x if memory is None else memory
    q = _split_heads(x @ p.wq.to(dtype), n_heads, head_dim)
    k = _split_heads(src @ p.wk.to(dtype), n_kv, head_dim)
    v = _split_heads(src @ p.wv.to(dtype), n_kv, head_dim)
    if memory is None:
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
        q = rope_apply(q, positions, theta)
        k = rope_apply(k, positions, theta)
    else:
        causal, window = False, 0
    q = q.reshape(B, S, n_kv, G, head_dim) * (head_dim ** -0.5)
    out = flash_attention(q, k, v, causal, window)
    kv = {"k": k, "v": v} if collect_kv else None
    return out.reshape(B, S, n_heads * head_dim) @ p.wo.to(dtype), kv


def cross_decode(
    p: Attention, x: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, *,
    n_heads: int, n_kv: int, head_dim: int,
) -> torch.Tensor:
    """One decode token's cross-attention over the cached encoder k/v, as
    JAX's ``_cross_decode``: f32 scores, the softmax cast to the compute
    dtype, then the combine. x: (B, 1, d); ck/cv: (B, T, Kv, hd). Returns
    (B, 1, d)."""
    B = x.shape[0]
    dtype = x.dtype
    G = n_heads // n_kv
    q = (x @ p.wq.to(dtype)).reshape(B, n_kv, G, head_dim) * (head_dim ** -0.5)
    scores = torch.einsum("bkgh,bskh->bkgs", q.float(), ck.float())
    w = torch.softmax(scores, dim=-1).to(dtype)
    out = torch.einsum("bkgs,bskh->bkgh", w, cv).reshape(B, 1, n_heads * head_dim)
    return out @ p.wo.to(dtype)


# ------------------------------------------------------------- dense caching
def init_kv_cache(
    B: int, cache_len: int, n_kv: int, head_dim: int, dtype, device
) -> Dict[str, torch.Tensor]:
    """An empty ring: zero rows, every position ``INVALID_POS``."""
    return {
        "k": torch.zeros((B, cache_len, n_kv, head_dim), dtype=dtype, device=device),
        "v": torch.zeros((B, cache_len, n_kv, head_dim), dtype=dtype, device=device),
        "pos": torch.full((cache_len,), INVALID_POS, dtype=torch.int32, device=device),
    }


def fill_kv_cache(
    cache: Dict[str, torch.Tensor], k: torch.Tensor, v: torch.Tensor,
    positions: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """Fill a fresh ring from prefill k/v (B, S, Kv, hd), in place: the
    trailing ``min(S, cache_len)`` positions, each at row ``pos %
    cache_len``. positions: (B, S), shared by the batch (row 0 is used)."""
    S_c, S = cache["k"].shape[1], k.shape[1]
    keep = min(S, S_c)
    pos = positions[0, S - keep:].to(torch.int32)
    rows = (pos % S_c).long()
    cache["k"][:, rows] = k[:, S - keep:]
    cache["v"][:, rows] = v[:, S - keep:]
    cache["pos"][rows] = pos
    return cache


def attention_decode(
    p: Attention,
    x: torch.Tensor,
    cache: Dict[str, torch.Tensor],
    t: int,
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    theta: float,
    window: int = 0,
) -> torch.Tensor:
    """One-token decode over a dense ring. x: (B, 1, d); t: this token's
    position, shared by the batch. Writes the roped k and the v into row
    ``t % cache_len`` (in place) and attends every valid row, masked by the
    position array (and the window). Returns (B, 1, d)."""
    B = x.shape[0]
    dtype = x.dtype
    G = n_heads // n_kv
    pos = torch.full((B, 1), t, dtype=torch.int32, device=x.device)
    q = rope_apply(_split_heads(x @ p.wq.to(dtype), n_heads, head_dim), pos, theta)
    k_new = rope_apply(_split_heads(x @ p.wk.to(dtype), n_kv, head_dim), pos, theta)
    v_new = _split_heads(x @ p.wv.to(dtype), n_kv, head_dim)

    slot = t % cache["k"].shape[1]
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    cache["pos"][slot] = t

    q = q.reshape(B, n_kv, G, head_dim) * (head_dim ** -0.5)
    scores = torch.einsum("bkgh,bskh->bkgs", q.float(), cache["k"].float())
    pos_c = cache["pos"]
    valid = (pos_c >= 0) & (pos_c <= t)
    if window > 0:
        valid = valid & (pos_c > t - window)
    w = torch.softmax(torch.where(valid, scores, NEG_INF), dim=-1).to(dtype)
    out = torch.einsum("bkgs,bskh->bkgh", w, cache["v"]).reshape(B, 1, n_heads * head_dim)
    return out @ p.wo.to(dtype)


def _write_rows(kp, vp, ksc, vsc, pid, slot, k_new, v_new):
    """New K/V rows into the pools at (pid, slot), in place; quantized (codes
    and scales at the same place) when scale pools are given. Returns the
    scale operands of the paged op."""
    if ksc is None:
        kp[pid, slot] = k_new
        vp[pid, slot] = v_new
        return {}
    k_codes, k_sc = quant.kv_quantize(k_new, kp.dtype)
    v_codes, v_sc = quant.kv_quantize(v_new, vp.dtype)
    kp[pid, slot] = k_codes
    vp[pid, slot] = v_codes
    ksc[pid, slot] = k_sc
    vsc[pid, slot] = v_sc
    return {"k_scale": ksc, "v_scale": vsc}


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
    ksc: Optional[torch.Tensor] = None,
    vsc: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One prefill chunk per slot against the paged pool (written in place).

    x: (B, T, d); kp/vp: (N, page, Kv, hd) at the compute dtype, or codes
    with scale pools ksc/vsc (N, page, Kv) f32; tables: (B, P) int32; start:
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
    # harmless (finite codes and scales), it is never attended unmasked
    scales = _write_rows(kp, vp, ksc, vsc, pid, slot, k_new, v_new)

    q = q.reshape(B, T, n_kv, G, head_dim) * (head_dim ** -0.5)
    out = paged_prefill_attention(q, kp, vp, tables, start, q_len, window=window,
                                  **scales)
    out = torch.where(valid[:, :, None, None, None], out, 0)
    out = out.to(dtype).reshape(B, T, n_heads * head_dim)
    return out @ p.wo.to(dtype)


def null_writer(tables: torch.Tensor, lengths: torch.Tensor, active: torch.Tensor,
                page: int) -> torch.Tensor:
    """(B,) the row whose K/V each decode row writes: its own where it writes
    its page, else the last row that writes the null page's (0, 0). Every
    write to (0, 0) then carries the same values, so the pool holds what
    JAX's scatter (and the CPU's in-order write) leaves there, the last such
    row's, where the card's duplicate stores would leave any one of them. An
    inactive row attends that place (a free slot's only key), and under MoE
    its output takes expert capacity from the active rows."""
    ok = active & (lengths // page < tables.shape[1])
    b = torch.arange(ok.shape[0], device=ok.device)
    return torch.where(ok, b, torch.where(ok, -1, b).max())


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
    ksc: Optional[torch.Tensor] = None,
    vsc: Optional[torch.Tensor] = None,
    null_src: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One decode token per slot against the paged pool (written in place).

    x: (B, 1, d); lengths: (B,) int32 tokens already cached per slot (the
    new token's position); active: (B,) bool — inactive slots write the null
    page and their output is garbage by contract. Pools and scale pools as in
    :func:`attention_prefill_paged`. ``null_src`` (B,) (``null_writer``)
    makes the rows that share the null page's (0, 0) write one row's K/V.
    Returns (B, 1, d)."""
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
    if null_src is not None:
        k_new, v_new = k_new[null_src], v_new[null_src]
    scales = _write_rows(kp, vp, ksc, vsc, page_ids, slot, k_new[:, 0], v_new[:, 0])

    q = q.reshape(B, n_kv, G, head_dim) * (head_dim ** -0.5)
    out = paged_attention(q, kp, vp, tables, lengths + 1, window=window, **scales)
    out = out.to(dtype).reshape(B, 1, n_heads * head_dim)
    return out @ p.wo.to(dtype)
