"""Public flash-attention op in the model's (B, S, Kv, G, hd) layout: the
CUDA kernels (K1 forward, K2 backward) for a CUDA tensor, the plain PyTorch
versions for a CPU tensor.

Counterpart of ``repro.kernels.flash_attention.ops``: the same flatten,
where query head ``h = (b * Kv + kv) * G + g`` reads kv head ``h // G``, and
one ``autograd.Function`` that saves ``(qf, kf, vf, of, lse)`` for the
backward, as the JAX custom_vjp does. The choice goes by the tensor's device
and nothing else: a CUDA tensor launches the kernels or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import on_cuda
from repro_torch.kernels.flash_attention import cuda
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_plain,
    flash_attention_fwd_plain,
)


def _flatten_q(q: torch.Tensor) -> torch.Tensor:
    B, S, Kv, G, hd = q.shape
    return q.permute(0, 2, 3, 1, 4).reshape(B * Kv * G, S, hd).contiguous()


def _unflatten_q(qf: torch.Tensor, B: int, Kv: int, G: int) -> torch.Tensor:
    BH, S, hd = qf.shape
    return qf.reshape(B, Kv, G, S, hd).permute(0, 3, 1, 2, 4)


def _flatten_kv(k: torch.Tensor) -> torch.Tensor:
    B, Sk, Kv, hd = k.shape
    return k.permute(0, 2, 1, 3).reshape(B * Kv, Sk, hd).contiguous()


def _unflatten_kv(kf: torch.Tensor, B: int, Kv: int) -> torch.Tensor:
    BKv, Sk, hd = kf.shape
    return kf.reshape(B, Kv, Sk, hd).permute(0, 2, 1, 3)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        B, S, Kv, G, hd = q.shape
        qf, kf, vf = _flatten_q(q), _flatten_kv(k), _flatten_kv(v)
        kw = dict(group=G, causal=causal, window=window)
        if on_cuda(q, "flash attention"):
            of, lse = cuda.flash_attention_fwd_cuda(qf, kf, vf, **kw)
        else:
            of, lse = flash_attention_fwd_plain(qf, kf, vf, **kw)
        ctx.save_for_backward(qf, kf, vf, of, lse)
        ctx.kw = kw
        return _unflatten_q(of, B, Kv, G)

    @staticmethod
    def backward(ctx, dout):
        qf, kf, vf, of, lse = ctx.saved_tensors
        B, S, Kv, G, hd = dout.shape
        dof = _flatten_q(dout)
        if on_cuda(qf, "flash attention"):
            bwd = cuda.flash_attention_bwd_cuda
        else:
            bwd = flash_attention_bwd_plain
        dqf, dkf, dvf = bwd(qf, kf, vf, of, lse, dof, **ctx.kw)
        return (_unflatten_q(dqf, B, Kv, G), _unflatten_kv(dkf, B, Kv),
                _unflatten_kv(dvf, B, Kv), None, None)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """q: (B, S, Kv, G, hd) pre-scaled; k/v: (B, Sk, Kv, hd) -> (B, S, Kv, G, hd)."""
    return _FlashAttention.apply(q, k, v, causal, window)
