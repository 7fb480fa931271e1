"""Plain PyTorch versions of the flash-attention kernels (K1, K2).

Counterparts of ``repro.kernels.flash_attention.ref.flash_attention_ref``,
in the flat layout the kernels take (``ops`` flattens the model's):

  q      (BH, S, hd)    query heads, pre-scaled by hd**-0.5
  k, v   (BKv, Sk, hd)  query head h reads kv head h // group
  o      (BH, S, hd);  lse (BH, S) f32 = m + log(max(l, 1e-30))

The forward takes a whole f32 softmax per row with JAX's masking: masked
scores are -1e30, p is chosen by a select and the denominator is clamped at
1e-30, so a fully masked row gives zeros and a finite lse. The backward is
autograd through that forward, the oracle ``tests/test_kernels_backward.py``
uses. Both are what ``ops`` runs for CPU tensors, and what
``chip_smoke.py`` holds each CUDA kernel against.
"""
from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e30


def visible_mask(S: int, Sk: int, *, causal: bool, window: int, device) -> torch.Tensor:
    """(S, Sk) bool: key j is visible to query i (``make_mask`` of the JAX
    kernel)."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((S, Sk), dtype=torch.bool, device=device)
    if causal:
        mask = qpos >= kpos
    if window > 0:
        mask = mask & (qpos - kpos < window)
    return mask


def _fwd_f32(q, k, v, group, causal, window):
    """(o f32, lse) from f32 inputs; the row max is a constant of the
    softmax, so it is detached and autograd sees no path through it."""
    S, Sk = q.shape[1], k.shape[1]
    k = k.repeat_interleave(group, dim=0)
    v = v.repeat_interleave(group, dim=0)
    mask = visible_mask(S, Sk, causal=causal, window=window, device=q.device)
    s = torch.where(mask, torch.einsum("hsd,htd->hst", q, k), NEG_INF)
    m = s.amax(dim=-1, keepdim=True).detach()
    p = torch.where(mask, torch.exp(s - m), 0.0)
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("hst,htd->hsd", p, v) / denom
    return o, (m + torch.log(denom))[..., 0]


def flash_attention_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, group: int,
    causal: bool = True, window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (o (BH, S, hd) q.dtype, lse (BH, S) f32)."""
    o, lse = _fwd_f32(q.float(), k.float(), v.float(), group, causal, window)
    return o.to(q.dtype), lse


def flash_attention_bwd_delta_plain(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """K2's first pass: rowsum(dO * O) in f32, (BH, S)."""
    return torch.sum(o.float() * do.float(), dim=-1)


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, *, group: int, causal: bool = True,
    window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) by autograd through the plain forward (``o`` and ``lse``
    are the kernel's residuals; the oracle recomputes its own)."""
    with torch.enable_grad():
        qf, kf, vf = (t.detach().float().requires_grad_(True) for t in (q, k, v))
        out, _ = _fwd_f32(qf, kf, vf, group, causal, window)
        dq, dk, dv = torch.autograd.grad(out, (qf, kf, vf), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
