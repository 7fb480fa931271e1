"""Fused RMSNorm op: the CUDA kernels (K3 forward, K4 backward) for a CUDA
tensor, the plain PyTorch versions for a CPU tensor.

Counterpart of ``repro.kernels.rmsnorm.ops``. One ``autograd.Function``
saves ``(x, scale)`` and recomputes ``inv`` in the backward, as the JAX
custom_vjp does; ``dscale`` comes out in f32 and is cast to
``scale.dtype``. The choice goes by the tensor's device and nothing else: a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import on_cuda
from repro_torch.kernels.rmsnorm import cuda
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_plain, rmsnorm_plain


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        if on_cuda(x, "rmsnorm"):
            d = x.shape[-1]
            return cuda.rmsnorm_fwd_cuda(x.reshape(-1, d), scale, eps).reshape(x.shape)
        return rmsnorm_plain(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        if on_cuda(x, "rmsnorm"):
            d = x.shape[-1]
            dx, dscale = cuda.rmsnorm_bwd_cuda(
                x.reshape(-1, d), scale, g.contiguous().reshape(-1, d), ctx.eps
            )
            dx = dx.reshape(x.shape)
        else:
            dx, dscale = rmsnorm_bwd_plain(x, scale, g, ctx.eps)
        return dx, dscale.to(scale.dtype), None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x (..., d) -> RMSNorm(x) * scale in f32, cast to x.dtype."""
    return _RMSNorm.apply(x, scale, eps)
