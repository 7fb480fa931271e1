"""Decoder stack: the full-sequence training forward and the paged serving
steps, over per-layer blocks.

Counterpart of ``stack_forward`` and the paged parts of
``repro.models.stack``. JAX scanned over stacked ``(L, ...)`` parameter
segments; here an ``nn.ModuleList`` holds one block per layer and a Python
loop walks it. ``layer_specs`` gives each layer its mixer kind and window,
exactly as in the JAX package. Remat is ``torch.utils.checkpoint`` over
groups of ``rt.remat_period`` layers: ``full`` saves only each group's
input, ``dots`` also saves every matmul output (``aten.mm``), the
counterpart of ``dots_with_no_batch_dims_saveable``.

The KV pools stay one K tensor and one V tensor of shape
``(L, num_pages, page, Kv, hd)`` (``init_stack_pool``), so a copy-on-write
page copy is a single ``pool[:, dst] = pool[:, src]`` and layer ``i`` works
on the contiguous view ``pool[i]``.
"""
from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import MLP, Norm, mlp_apply, norm_apply
from repro_torch.models.runtime import Runtime


class LayerSpec(NamedTuple):
    kind: str       # attn | local | rglru | mamba
    window: int     # 0 = full attention
    cache_len: int  # kv cache entries (attention kinds only)


# --------------------------------------------------------------------- specs
def layer_specs(
    cfg: ArchConfig, *, seq_len: int, long_variant: bool = False
) -> Tuple[LayerSpec, ...]:
    kinds = cfg.mixer_kinds()
    out: List[LayerSpec] = []
    if long_variant and cfg.long_context == "sw_variant":
        for i in range(cfg.n_layers):
            if (i + 1) % cfg.lc_global_every == 0:
                out.append(LayerSpec("attn", 0, seq_len))
            else:
                w = cfg.lc_window
                out.append(LayerSpec("local", w, min(w, seq_len)))
        return tuple(out)
    for k in kinds:
        if k == "attn":
            out.append(LayerSpec("attn", 0, seq_len))
        elif k == "local":
            w = cfg.sliding_window
            out.append(LayerSpec("local", w, min(w, seq_len)))
        else:
            out.append(LayerSpec(k, 0, 0))
    return tuple(out)


def check_served(cfg: ArchConfig) -> None:
    """Raise for what this slice does not serve: non-attention mixers,
    MoE or no FFN, encoder-decoder and modality-prefix configs."""
    if not all(k in ("attn", "local") for k in cfg.pattern) or not cfg.n_heads:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.pattern} mixers are ROADMAP queue 1, "
            "'the other families'"
        )
    if cfg.ffn_kind != "dense" or cfg.is_encdec or cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: ffn={cfg.ffn_kind!r}, enc-dec or frontend "
            f"{cfg.frontend!r} is ROADMAP queue 1, 'the other families'"
        )


# -------------------------------------------------------------------- blocks
class Block(nn.Module):
    """One decoder layer: norm1 -> attention -> norm2 -> dense FFN."""

    def __init__(self, norm1: Norm, mixer: attn_mod.Attention, norm2: Norm, ffn: MLP):
        super().__init__()
        self.norm1, self.mixer, self.norm2, self.ffn = norm1, mixer, norm2, ffn

    @classmethod
    def init(cls, cfg: ArchConfig, gen: torch.Generator, dtype) -> "Block":
        dev = gen.device
        return cls(
            Norm.init(cfg.norm, cfg.d_model, dev),
            attn_mod.Attention.init(
                gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, dtype
            ),
            Norm.init(cfg.norm, cfg.d_model, dev),
            MLP.init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_gated, dtype),
        )


class Stack(nn.Module):
    def __init__(self, layers: List[Block]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    @classmethod
    def init(cls, cfg: ArchConfig, gen: torch.Generator, dtype) -> "Stack":
        check_served(cfg)
        return cls([Block.init(cfg, gen, dtype) for _ in range(cfg.n_layers)])


def _ffn_apply(cfg: ArchConfig, p: Block, x: torch.Tensor) -> torch.Tensor:
    h = norm_apply(p.norm2, x, cfg.norm)
    return x + mlp_apply(p.ffn, h, cfg.mlp_gated)


# --------------------------------------------------------------------- pools
def init_stack_pool(
    cfg: ArchConfig,
    rt: Runtime,
    specs: Tuple[LayerSpec, ...],
    num_pages: int,
    page_size: int,
    *,
    device,
) -> Dict[str, torch.Tensor]:
    """Paged KV pools of every layer, ``{"k", "v"}`` each
    ``(L, num_pages, page, Kv, hd)`` — the JAX package's per-layer
    ``init_paged_kv_cache`` pools, stacked. Every layer shares one block
    table per request (the vLLM convention), so all layers have the same
    page geometry. Page 0 is the reserved null page: block-table padding
    and inactive-slot writes go there, and reads of it are always masked.
    The pools are zeros: a plain version gathers page 0 and multiplies
    masked weights of 0 by its values, so garbage there would become NaN."""
    for spec in specs:
        if spec.kind not in ("attn", "local"):
            raise NotImplementedError(
                f"paged decode supports attention mixers only, got {spec.kind}"
            )
    attn_mod.check_kv_dtype(rt.kv_dtype)
    shape = (len(specs), num_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=rt.dtype, device=device),
        "v": torch.zeros(shape, dtype=rt.dtype, device=device),
    }


# --------------------------------------------------------------------- apply
def _layer_apply(
    cfg: ArchConfig, bp: Block, x: torch.Tensor, spec: LayerSpec,
    positions: torch.Tensor, causal: bool,
) -> torch.Tensor:
    h = norm_apply(bp.norm1, x, cfg.norm)
    x = x + attn_mod.attention_apply(
        bp.mixer, h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.head_dim, theta=cfg.rope_theta, window=spec.window,
        causal=causal, positions=positions,
    )
    return _ffn_apply(cfg, bp, x)


def _group_apply(cfg, blocks, specs, positions, causal, x):
    for bp, spec in zip(blocks, specs):
        x = _layer_apply(cfg, bp, x, spec, positions, causal)
    return x


def _save_matmuls():
    return create_selective_checkpoint_contexts([torch.ops.aten.mm.default])


def stack_forward(
    cfg: ArchConfig,
    stack: Stack,
    x: torch.Tensor,
    rt: Runtime,
    specs: Tuple[LayerSpec, ...],
    *,
    positions: Optional[torch.Tensor] = None,
    memory: Optional[torch.Tensor] = None,
    causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, None]:
    """Full-sequence forward. x: (B, S, d) embedded. Returns (x, aux, None):
    the router aux loss is 0 for the dense families this slice covers, and
    cache collection belongs to the whole-prompt prefill (ROADMAP queue 1)."""
    check_served(cfg)
    if memory is not None:
        raise NotImplementedError(
            "encoder memory (cross-attention) is ROADMAP queue 1 item 4, "
            "'the other families'"
        )
    B, S = x.shape[0], x.shape[1]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    layers = list(stack.layers)
    k = rt.remat_period
    for i in range(0, len(layers), k):
        fn = functools.partial(_group_apply, cfg, layers[i:i + k], specs[i:i + k],
                               positions, causal)
        if rt.remat == "none":
            x = fn(x)
        elif rt.remat == "full":
            x = checkpoint(fn, x, use_reentrant=False)
        else:
            x = checkpoint(fn, x, use_reentrant=False, context_fn=_save_matmuls)
    return x, torch.zeros((), dtype=torch.float32, device=x.device), None


def stack_prefill_paged(
    cfg: ArchConfig,
    stack: Stack,
    x: torch.Tensor,
    pools: Dict[str, torch.Tensor],
    tables: torch.Tensor,
    start: torch.Tensor,
    q_len: torch.Tensor,
    rt: Runtime,
    specs: Tuple[LayerSpec, ...],
) -> torch.Tensor:
    """One prefill chunk through the stack, writing KV into pool pages in
    place. x: (B, T, d) embedded chunk. Returns the hidden states."""
    for i, (bp, spec) in enumerate(zip(stack.layers, specs)):
        hn = norm_apply(bp.norm1, x, cfg.norm)
        x = x + attn_mod.attention_prefill_paged(
            bp.mixer, hn, pools["k"][i], pools["v"][i], tables, start, q_len,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
            theta=cfg.rope_theta, window=spec.window,
        )
        x = _ffn_apply(cfg, bp, x)
    return x


def stack_decode(
    cfg: ArchConfig,
    stack: Stack,
    x: torch.Tensor,
    pools: Dict[str, torch.Tensor],
    lengths: torch.Tensor,
    rt: Runtime,
    specs: Tuple[LayerSpec, ...],
    *,
    tables: torch.Tensor,
    active: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One-token paged decode (the paged branch of the JAX ``stack_decode``).
    x: (B, 1, d); ``lengths`` the per-slot positions; each slot decodes at
    its own depth. Pools are written in place."""
    if active is None:
        active = torch.ones(lengths.shape, dtype=torch.bool, device=x.device)
    for i, (bp, spec) in enumerate(zip(stack.layers, specs)):
        hn = norm_apply(bp.norm1, x, cfg.norm)
        x = x + attn_mod.attention_decode_paged(
            bp.mixer, hn, pools["k"][i], pools["v"][i], tables, lengths, active,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
            theta=cfg.rope_theta, window=spec.window,
        )
        x = _ffn_apply(cfg, bp, x)
    return x
