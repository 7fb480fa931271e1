"""Mamba-1 selective SSM block (the Falcon-Mamba architecture).

Counterpart of ``repro.models.ssm``. The full-sequence path (training, and
the prefill with its collected decode state) runs the recurrence as an
associative scan over time, or as a chunked scan (associative within a
chunk, sequential across chunks: less peak memory); decode is one recurrent
step on an O(1) state.

State-space recurrence (per channel c, state s):
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t
    y_t = C_t . h_t + D * x_t

The arithmetic is the JAX package's, dtype by dtype: the projections and
the causal conv at the compute dtype (the conv's K taps as unrolled adds,
each rounded to the dtype, as JAX adds them), ``dt``, ``a``, ``b``, ``h``
and the readout in f32, the readout cast back. ``softplus`` is
``logaddexp(x, 0)`` (``jax.nn.softplus``; ``F.softplus`` returns x itself
above its threshold), and ``silu`` is XLA's expansion
(``layers.silu``). :func:`assoc_scan` pairs the elements as
``jax.lax.associative_scan`` does, so its sums come out in JAX's order.

JAX runs this block in plain ``jnp`` (``lax.associative_scan``, no Pallas
kernel); its products and elementwise steps stay plain PyTorch here. The
sequence-parallel scan (``mamba_apply_seqpar``) is ROADMAP queue 1 item 6.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import dense_init, frozen, silu


def dt_rank(d_inner: int) -> int:
    return max(1, d_inner // 16)


class Mamba(nn.Module):
    """One Mamba-1 mixer, under the JAX tree's names: ``in_proj`` (d,
    2 d_inner), ``conv_w`` (K, d_inner) and ``conv_b`` (d_inner,),
    ``x_proj`` (d_inner, r + 2 state), ``dt_proj`` (r, d_inner), ``dt_bias``
    (d_inner,), ``A_log`` (d_inner, state), ``D`` (d_inner,), ``out_proj``
    (d_inner, d). The matmul weights and ``conv_w`` may be stored at the
    compute dtype (JAX casts them at every use); ``conv_b``, ``dt_bias``,
    ``A_log`` and ``D`` stay f32."""

    def __init__(self, in_proj, conv_w, conv_b, x_proj, dt_proj, dt_bias, A_log, D,
                 out_proj):
        super().__init__()
        self.in_proj = frozen(in_proj)
        self.conv_w = frozen(conv_w)
        self.conv_b = frozen(conv_b.float())
        self.x_proj = frozen(x_proj)
        self.dt_proj = frozen(dt_proj)
        self.dt_bias = frozen(dt_bias.float())
        self.A_log = frozen(A_log.float())
        self.D = frozen(D.float())
        self.out_proj = frozen(out_proj)

    @classmethod
    def init(cls, gen: torch.Generator, d: int, d_inner: int, state: int, conv: int,
             dtype) -> "Mamba":
        """The distributions of ``repro.models.ssm.init_mamba`` on ``gen``'s
        device: fan-in truncated-normal projections (``dt_proj`` scaled by
        sqrt(r)), ``conv_w`` 0.1 N(0, 1), the S4D-real ``A_log`` = log(s + 1),
        ``dt_bias`` = softplus^-1(U(1e-3, 1e-1)), ``D`` = 1, ``conv_b`` = 0."""
        dev = gen.device
        r = dt_rank(d_inner)
        conv_w = torch.empty(conv, d_inner, device=dev).normal_(0.0, 1.0, generator=gen)
        dt_init = torch.empty(d_inner, device=dev).uniform_(1e-3, 1e-1, generator=gen)
        A = torch.arange(1, state + 1, dtype=torch.float32, device=dev).repeat(d_inner, 1)
        return cls(
            dense_init(gen, d, 2 * d_inner, dtype=dtype),
            (0.1 * conv_w).to(dtype),
            torch.zeros(d_inner, device=dev),
            dense_init(gen, d_inner, r + 2 * state, dtype=dtype),
            dense_init(gen, r, d_inner, dtype=dtype, scale=r ** 0.5),
            torch.log(torch.expm1(dt_init)),
            torch.log(A),
            torch.ones(d_inner, device=dev),
            dense_init(gen, d_inner, d, dtype=dtype),
        )


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, C); w: (K, C) at x's dtype. K
    unrolled multiply-adds, each rounded to x's dtype (JAX's order)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + xp[:, i: i + S] * w[i]
    return out + b.to(x.dtype)


def _ssm_coeffs(p: Mamba, x_conv: torch.Tensor):
    """Input-dependent discretised (a, b), f32 (B, S, d_inner, state), and
    the readout C (B, S, state) at the compute dtype."""
    dtype = x_conv.dtype
    r = p.dt_proj.shape[0]
    state = (p.x_proj.shape[1] - r) // 2
    dbc = x_conv @ p.x_proj.to(dtype)
    dt_lo, B_ssm, C_ssm = torch.split(dbc, [r, state, state], dim=-1)
    z = (dt_lo @ p.dt_proj.to(dtype)).float() + p.dt_bias
    dt = torch.logaddexp(z, torch.zeros_like(z))                # jax.nn.softplus
    A = -torch.exp(p.A_log)                                      # (di, s)
    a = torch.exp(dt[..., None] * A)
    b = (dt * x_conv.float())[..., None] * B_ssm.float()[..., None, :]
    return a, b, C_ssm


def _readout(p: Mamba, h: torch.Tensor, C_ssm: torch.Tensor,
             x_conv: torch.Tensor) -> torch.Tensor:
    y = torch.matmul(h, C_ssm.float()[..., None])[..., 0]
    return (y + p.D * x_conv.float()).to(x_conv.dtype)


def _combine(a1, b1, a2, b2):
    return a1 * a2, a2 * b1 + b2


def _interleave(first: torch.Tensor, even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """[first[:, 0], odd[:, 0], even[:, 0], odd[:, 1], even[:, 1], ...] along
    axis 1 (``jax.lax``'s ``_interleave`` of [first[:, :1]; even] and odd)."""
    out = torch.empty_like(first)
    out[:, :1] = first[:, :1]
    out[:, 1::2] = odd
    out[:, 2::2] = even
    return out


def assoc_scan(a: torch.Tensor, b: torch.Tensor, keep_a: bool = True
               ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Inclusive scan of (a, b) over axis 1 under ``combine((a1, b1), (a2,
    b2)) = (a1 a2, a2 b1 + b2)``: ``jax.lax.associative_scan``'s odd/even
    recursion (``_scan`` in ``jax/_src/lax/control_flow/loops.py``), the
    same pairs combined in the same order, log2(S) levels deep. Without
    ``keep_a`` the top level's products of a are not assembled (None)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = assoc_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    return (_interleave(a, ea, oa) if keep_a else None), _interleave(b, eb, ob)


def chunked_scan(a: torch.Tensor, b: torch.Tensor, chunk: int) -> torch.Tensor:
    """h over axis 1 in chunks of ``chunk`` positions: :func:`assoc_scan`
    within a chunk, the carried state folded in after it (JAX's ``lax.scan``
    over chunks)."""
    B, S = a.shape[:2]
    assert S % chunk == 0, (S, chunk)
    h0 = torch.zeros((B,) + a.shape[2:], dtype=a.dtype, device=a.device)
    hs = []
    for c in range(0, S, chunk):
        A_c, Bh = assoc_scan(a[:, c: c + chunk], b[:, c: c + chunk])
        h_chunk = Bh + A_c * h0[:, None]
        h0 = h_chunk[:, -1]
        hs.append(h_chunk)
    return torch.cat(hs, dim=1)


def mamba_apply(p: Mamba, x: torch.Tensor, *, scan_mode: str = "assoc", chunk: int = 256,
                collect_state: bool = False):
    """Full-sequence Mamba. x: (B, S, d) -> (B, S, d), and with
    ``collect_state`` the decode state after the last position: ``{"conv":
    the last K - 1 inputs of the conv (B, K - 1, d_inner), left-padded with
    zeros when S < K - 1, "ssm": h (B, d_inner, state) f32}``, copies that
    hold none of the sequence's activations alive."""
    dtype = x.dtype
    xz = x @ p.in_proj.to(dtype)
    x_in, z = xz.chunk(2, dim=-1)
    x_conv = silu(_causal_conv(x_in, p.conv_w.to(dtype), p.conv_b))
    a, b, C_ssm = _ssm_coeffs(p, x_conv)
    if scan_mode == "assoc":
        _, h = assoc_scan(a, b, keep_a=False)
    else:
        h = chunked_scan(a, b, chunk)
    del a, b
    y = _readout(p, h, C_ssm, x_conv)
    out = (y * silu(z)) @ p.out_proj.to(dtype)
    if not collect_state:
        return out
    K, S = p.conv_w.shape[0], x.shape[1]
    if S >= K - 1:
        conv_state = x_in[:, S - (K - 1):].clone()
    else:
        conv_state = F.pad(x_in, (0, 0, K - 1 - S, 0))
    return out, {"conv": conv_state, "ssm": h[:, -1].clone()}


def init_mamba_state(p: Mamba, B: int, dtype) -> Dict[str, torch.Tensor]:
    """The empty decode state on the parameters' device: the conv's last
    K - 1 inputs at ``dtype``, h in f32."""
    d_inner = p.in_proj.shape[1] // 2
    K = p.conv_w.shape[0]
    r = p.dt_proj.shape[0]
    state = (p.x_proj.shape[1] - r) // 2
    dev = p.in_proj.device
    return {
        "conv": torch.zeros((B, K - 1, d_inner), dtype=dtype, device=dev),
        "ssm": torch.zeros((B, d_inner, state), dtype=torch.float32, device=dev),
    }


def mamba_decode(p: Mamba, x: torch.Tensor, cache: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One recurrent step. x: (B, 1, d). Returns (out (B, 1, d), the next
    state). The conv's K taps are a dot (JAX's ``einsum``): exact f32
    products summed in f32, rounded once to the dtype."""
    dtype = x.dtype
    xz = x[:, 0] @ p.in_proj.to(dtype)
    x_in, z = xz.chunk(2, dim=-1)                                # (B, di)
    hist = torch.cat([cache["conv"], x_in[:, None]], dim=1)      # (B, K, di)
    tap = (hist.float() * p.conv_w.float()).sum(dim=1).to(dtype)
    x_conv = silu(tap + p.conv_b.to(dtype))
    a, b, C_ssm = _ssm_coeffs(p, x_conv[:, None])                # (B, 1, di, s)
    h = a[:, 0] * cache["ssm"] + b[:, 0]
    y = _readout(p, h, C_ssm[:, 0], x_conv)
    out = (y * silu(z)) @ p.out_proj.to(dtype)
    return out[:, None], {"conv": hist[:, 1:], "ssm": h}
