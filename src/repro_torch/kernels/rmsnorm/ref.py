"""Plain PyTorch versions of the fused RMSNorm kernels (K3, K4).

Counterparts of ``repro.kernels.rmsnorm.ref.rmsnorm_ref`` (forward) and of
the backward that ``repro.kernels.rmsnorm.kernel._rmsnorm_bwd_kernel``
computes, written out: with ``xhat = x * inv`` and ``gs = g * scale``,

  dx     = inv * (gs - xhat * mean(gs * xhat))
  dscale = sum over rows of g * xhat          (f32)

They are what ``ops`` runs for CPU tensors, and what ``chip_smoke.py`` holds
each CUDA kernel against. x is (..., d); scale (d,).
"""
from __future__ import annotations

from typing import Tuple

import torch


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * inv * scale.float()).to(x.dtype)


def rmsnorm_bwd_plain(
    x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, eps: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (dx with x's shape and dtype, dscale (d,) f32)."""
    d = x.shape[-1]
    xf = x.float().reshape(-1, d)
    gf = g.float().reshape(-1, d)
    s = scale.float()
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xhat = xf * inv
    gs = gf * s
    rowmean = torch.mean(gs * xhat, dim=-1, keepdim=True)
    dx = inv * (gs - xhat * rowmean)
    dscale = torch.sum(gf * xhat, dim=0)
    return dx.to(x.dtype).reshape(x.shape), dscale
