"""RG-LRU recurrent block (Griffin / RecurrentGemma).

Counterpart of ``repro.models.rglru``. Block structure (Griffin's
"recurrent block"):

    u    = x @ w_in            (width w)
    gate = gelu(x @ w_gate)
    u    = causal_conv(u)
    h_t  = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)       (RG-LRU)
    out  = (h * gate) @ w_out

with input gate i_t = sigmoid(Wx u_t + bx), recurrence gate r_t =
sigmoid(Wa u_t + ba), a_t = exp(-c * softplus(Lambda) * r_t), c = 8. Wa
and Wx are block-diagonal (``N_BLOCKS`` blocks).

The arithmetic is the JAX package's, dtype by dtype: the projections, the
block-diagonal gate products and the causal conv (``ssm._causal_conv``) at
the compute dtype; the sigmoids, ``log_a``, ``a``, ``beta``, the gated input
and h in f32, the readout cast back. ``gelu`` is ``jax.nn.gelu``'s tanh
approximation written as JAX writes it (``gelu_tanh``: its constants
rounded to the dtype, each step rounded to it), ``softplus`` is
``logaddexp(x, 0)`` and the sigmoid XLA's expansion ``1 / (1 + exp(-x))``.
The full-sequence recurrence is ``ssm.assoc_scan``, which pairs the elements
as ``jax.lax.associative_scan`` does.

JAX runs this block in plain ``jnp`` (``lax.associative_scan``, no Pallas
kernel); it stays plain PyTorch here. The sequence-parallel scan
(``rglru_apply_seqpar``) is ROADMAP queue 1 item 6.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.models.layers import dense_init, frozen
from repro_torch.models.ssm import _causal_conv, assoc_scan

RG_C = 8.0
N_BLOCKS = 8


class RGLRU(nn.Module):
    """One RG-LRU mixer, under the JAX tree's names: ``w_in`` and ``w_gate``
    (d, w), ``conv_w`` (K, w) and ``conv_b`` (w,), the block-diagonal gate
    weights ``gate_a`` and ``gate_x`` (N_BLOCKS, w / N_BLOCKS, w / N_BLOCKS)
    with their biases ``bias_a`` and ``bias_x`` (w,), ``lam`` (w,) and
    ``w_out`` (w, d). The matmul weights, ``conv_w`` and the gate blocks may
    be stored at the compute dtype (JAX casts them at every use); ``conv_b``,
    the gate biases and ``lam`` stay f32."""

    def __init__(self, w_in, w_gate, conv_w, conv_b, gate_a, bias_a, gate_x, bias_x, lam,
                 w_out):
        super().__init__()
        self.w_in = frozen(w_in)
        self.w_gate = frozen(w_gate)
        self.conv_w = frozen(conv_w)
        self.conv_b = frozen(conv_b.float())
        self.gate_a = frozen(gate_a)
        self.bias_a = frozen(bias_a.float())
        self.gate_x = frozen(gate_x)
        self.bias_x = frozen(bias_x.float())
        self.lam = frozen(lam.float())
        self.w_out = frozen(w_out)

    @classmethod
    def init(cls, gen: torch.Generator, d: int, width: int, conv: int, dtype) -> "RGLRU":
        """The distributions of ``repro.models.rglru.init_rglru`` on
        ``gen``'s device: ``lam`` = softplus^-1(-log(a) / c) for a uniform in
        [0.9, 0.999], the gate blocks N(0, 1 / bs), fan-in truncated-normal
        projections, ``conv_w`` 0.1 N(0, 1), zero biases."""
        dev = gen.device
        bs = width // N_BLOCKS
        lam = torch.empty(width, device=dev).uniform_(0.9, 0.999, generator=gen)
        lam = torch.log(torch.expm1(-torch.log(lam) / RG_C))

        def blk():
            w = torch.empty(N_BLOCKS, bs, bs, device=dev).normal_(0.0, 1.0, generator=gen)
            return (bs ** -0.5 * w).to(dtype)

        w_in = dense_init(gen, d, width, dtype=dtype)
        w_gate = dense_init(gen, d, width, dtype=dtype)
        conv_w = torch.empty(conv, width, device=dev).normal_(0.0, 1.0, generator=gen)
        zeros = functools.partial(torch.zeros, width, device=dev)
        return cls(w_in, w_gate, (0.1 * conv_w).to(dtype), zeros(), blk(), zeros(), blk(),
                   zeros(), lam, dense_init(gen, width, d, dtype=dtype))


@functools.lru_cache(maxsize=None)
def _const(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as JAX converts a constant to the
    array's dtype before it multiplies."""
    return float(torch.tensor(value, dtype=torch.float64).to(dtype))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x)`` (``approximate=True``) as JAX writes it:
    ``x * (0.5 * (1 + tanh(sqrt(2 / pi) * (x + 0.044715 * x**3))))``, the
    constants at x's dtype and each step rounded to it (``x**3`` is XLA's
    ``x * x * x``)."""
    c = _const(0.044715, x.dtype)
    s = _const(math.sqrt(2 / math.pi), x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(s * (x + c * (x * x * x))))
    return x * cdf


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    return 1 / (1 + torch.exp(-x))


def _block_diag(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """u: (..., width) x block-diagonal w: (nb, bs, bs) -> (..., width), the
    product and the bias at u's dtype."""
    nb, bs, _ = w.shape
    ub = u.reshape(u.shape[:-1] + (nb, bs))
    out = torch.einsum("...nc,ncd->...nd", ub, w.to(u.dtype))
    return out.reshape(u.shape) + b.to(u.dtype)


def _gates(p: RGLRU, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a_t, the gated input beta * i * u), both f32. u: (..., w)."""
    r = _sigmoid(_block_diag(u, p.gate_a, p.bias_a).float())
    i = _sigmoid(_block_diag(u, p.gate_x, p.bias_x).float())
    softplus = torch.logaddexp(p.lam, torch.zeros_like(p.lam))     # jax.nn.softplus
    log_a = -RG_C * softplus * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * i * u.float()


def rglru_apply(p: RGLRU, x: torch.Tensor, *, collect_state: bool = False):
    """Full-sequence recurrent block. x: (B, S, d) -> (B, S, d), and with
    ``collect_state`` the decode state after the last position: ``{"conv":
    the last K - 1 rows of the conv's input x @ w_in (B, K - 1, w),
    left-padded with zeros when S < K - 1, "h": the scan's last row (B, w)
    f32}``, copies that hold none of the sequence's activations alive."""
    dtype = x.dtype
    xi = x @ p.w_in.to(dtype)
    gate = gelu_tanh(x @ p.w_gate.to(dtype))
    u = _causal_conv(xi, p.conv_w.to(dtype), p.conv_b)
    a, b = _gates(p, u)
    _, h = assoc_scan(a, b, keep_a=False)
    del a, b
    out = (h.to(dtype) * gate) @ p.w_out.to(dtype)
    if not collect_state:
        return out
    K, S = p.conv_w.shape[0], x.shape[1]
    if S >= K - 1:
        conv_state = xi[:, S - (K - 1):].clone()
    else:
        conv_state = torch.nn.functional.pad(xi, (0, 0, K - 1 - S, 0))
    return out, {"conv": conv_state, "h": h[:, -1].clone()}


def rglru_apply_seqpar(p: RGLRU, x: torch.Tensor, **kw):
    """The sequence-parallel RG-LRU (JAX's shard_map halo and chunk-summary
    handoff) needs a device mesh: ROADMAP queue 1 item 6."""
    raise NotImplementedError(
        "rglru_apply_seqpar is not in the PyTorch port yet (ROADMAP.md queue 1: item 6, "
        "the sequence-parallel scans)"
    )


def init_rglru_state(p: RGLRU, B: int, dtype) -> Dict[str, torch.Tensor]:
    """The empty decode state on the parameters' device: the conv's last
    K - 1 inputs at ``dtype``, h in f32."""
    width = p.w_in.shape[1]
    K = p.conv_w.shape[0]
    dev = p.w_in.device
    return {
        "conv": torch.zeros((B, K - 1, width), dtype=dtype, device=dev),
        "h": torch.zeros((B, width), dtype=torch.float32, device=dev),
    }


def rglru_decode(p: RGLRU, x: torch.Tensor, cache: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One recurrent step. x: (B, 1, d). Returns (out (B, 1, d), the next
    state). The conv of the history is JAX's ``einsum`` over the K taps:
    exact f32 products summed in f32, rounded once to the dtype."""
    dtype = x.dtype
    u_new = x[:, 0] @ p.w_in.to(dtype)                            # (B, w)
    gate = gelu_tanh(x[:, 0] @ p.w_gate.to(dtype))
    hist = torch.cat([cache["conv"], u_new[:, None]], dim=1)      # (B, K, w)
    tap = (hist.float() * p.conv_w.float()).sum(dim=1).to(dtype)
    u = tap + p.conv_b.to(dtype)
    a, b = _gates(p, u)
    h = a * cache["h"] + b
    out = (h.to(dtype) * gate) @ p.w_out.to(dtype)
    return out[:, None], {"conv": hist[:, 1:], "h": h}
