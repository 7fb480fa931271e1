"""Shared primitive layers: init helpers, norms, RoPE, MLPs, embeddings.

Counterpart of ``repro.models.layers``. Parameters live in small
``nn.Module``s whose tensors are ``nn.Parameter``s, built frozen (serving
has no backward pass); training turns ``requires_grad`` on over the whole
tree (``train.loop.make_state``). The ``*_apply`` functions take a module
plus activations and keep the JAX package's numerics:

* norms compute in f32 and cast back; the scale multiplies in f32. RMSNorm
  goes through ``kernels.rmsnorm`` (K3/K4 on a CUDA tensor, the plain
  version on a CPU tensor) on every path, serving included; LayerNorm stays
  plain, as JAX has no fused LayerNorm;
* RoPE is half-split with f32 angles;
* logits are f32, from the f32 head (or the f32 embedding table when tied),
  while the embedding lookup uses the table cast to the compute dtype.

Matmul weights may be stored once in the compute dtype for serving: JAX
casts them at every use, and a cast of an already-cast tensor is the
identity. Training keeps f32 masters and casts at each use, as JAX does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.rmsnorm import rmsnorm


def frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# --------------------------------------------------------------------- init
def dense_init(
    gen: torch.Generator, d_in: int, d_out: int, *, dtype=torch.float32,
    scale: float = 1.0,
) -> torch.Tensor:
    """Truncated-normal fan-in init on ``gen``'s device, drawn in f32 and
    stored at ``dtype``. Matches ``repro.models.layers.dense_init`` in
    distribution, not bit for bit."""
    w = torch.empty(d_in, d_out, dtype=torch.float32, device=gen.device)
    nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return (w * (scale / math.sqrt(d_in))).to(dtype)


# --------------------------------------------------------------------- norms
class Norm(nn.Module):
    def __init__(self, scale: torch.Tensor, bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.scale = frozen(scale.float())
        self.bias = None if bias is None else frozen(bias.float())

    @classmethod
    def init(cls, norm: str, d: int, device) -> "Norm":
        bias = torch.zeros(d, device=device) if norm == "layernorm" else None
        return cls(torch.ones(d, device=device), bias)


def norm_apply(p: Norm, x: torch.Tensor, norm: str, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm / LayerNorm in f32, result cast back to x.dtype."""
    if norm == "rmsnorm":
        return rmsnorm(x, p.scale, eps)
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps) * p.scale
    if p.bias is not None:
        out = out + p.bias
    return out.to(dtype)


# ---------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_apply(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                       # (hd/2,)
    angles = positions[..., :, None].float() * freqs              # (..., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]                      # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1f, x2f = x[..., : hd // 2].float(), x[..., hd // 2:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------- MLP
class MLP(nn.Module):
    def __init__(
        self, w_up: torch.Tensor, w_down: torch.Tensor,
        w_gate: Optional[torch.Tensor] = None,
    ):
        super().__init__()
        self.w_up = frozen(w_up)
        self.w_down = frozen(w_down)
        self.w_gate = None if w_gate is None else frozen(w_gate)

    @classmethod
    def init(cls, gen, d: int, hidden: int, gated: bool, dtype) -> "MLP":
        return cls(
            dense_init(gen, d, hidden, dtype=dtype),
            dense_init(gen, hidden, d, dtype=dtype),
            dense_init(gen, d, hidden, dtype=dtype) if gated else None,
        )


def mlp_apply(p: MLP, x: torch.Tensor, gated: bool, act: str = "silu") -> torch.Tensor:
    dtype = x.dtype
    up = x @ p.w_up.to(dtype)
    a = getattr(F, act)
    h = a(x @ p.w_gate.to(dtype)) * up if gated else a(up)
    return h @ p.w_down.to(dtype)


# ----------------------------------------------------------------- embedding
class Embed(nn.Module):
    def __init__(self, table: torch.Tensor):
        super().__init__()
        self.table = frozen(table)

    @classmethod
    def init(cls, gen, vocab: int, d: int, dtype) -> "Embed":
        t = torch.empty(vocab, d, dtype=torch.float32, device=gen.device)
        t.normal_(0.0, 1.0, generator=gen)
        return cls((0.02 * t).to(dtype))


class Head(nn.Module):
    def __init__(self, w: torch.Tensor):
        super().__init__()
        self.w = frozen(w.float())


def embed_apply(p: Embed, ids: torch.Tensor, dtype) -> torch.Tensor:
    # gather-then-cast == cast-then-gather, without casting the whole table
    return p.table[ids].to(dtype)


def logits_apply(
    head: Optional[Head], embed: Embed, x: torch.Tensor, tied: bool
) -> torch.Tensor:
    """Final projection to (padded) vocab. Logits in f32 for a stable softmax."""
    xf = x.float()
    if tied:
        return xf @ embed.table.float().T
    if head is None:
        raise ValueError("untied embeddings need a head")
    return xf @ head.w
