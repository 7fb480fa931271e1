"""Decoder stack: the full-sequence forward (training, and whole-prompt
prefill with collected caches), the dense ring-cache decode and the paged
serving steps, over per-layer blocks whose mixer is attention, a Mamba-1
SSM (``models/ssm.py``) or an RG-LRU (``models/rglru.py``) and whose FFN
is a dense MLP, a MoE (``models/moe.py``, with an optional always-on
``extra_mlp``) or none (the SSM family's mixer-only blocks); the forward
sums the MoE layers' router aux, the serving steps drop it, as JAX does.
An encoder-decoder's decoder blocks also hold a cross-attention over the
encoder's output (``memory``), after the mixer (JAX's ``_cross_apply``);
its encoder is a stack of its own (``lm.encode``).

Counterpart of ``stack_forward``, ``write_prefill_to_pool``,
``stack_decode`` (dense and paged), the paged prefill and the pipeline stage
of ``repro.models.stack``. JAX scanned over stacked ``(L, ...)`` parameter
segments; here an ``nn.ModuleList`` holds one block per layer and a Python
loop walks it. ``layer_specs`` gives each layer its mixer kind and window,
exactly as in the JAX package. ``param_groups`` is JAX's parameter
storage: one group of stacked ``(L, ...)`` leaves for a homogeneous stack,
and for a patterned one (recurrentgemma's rglru, rglru, local unit) a group
of ``R`` repeats of the unit and a group for the tail; ``Stack.layout``
maps each layer to its (group, unit position, repeat), the index of its
leaves in JAX's tree. Remat is ``torch.utils.checkpoint`` over
groups of ``rt.remat_period`` layers: ``full`` saves only each group's
input, ``dots`` also saves every matmul output (``aten.mm``), the
counterpart of ``dots_with_no_batch_dims_saveable``.

The KV pools stay one K tensor and one V tensor of shape
``(L, num_pages, page, Kv, hd)`` (``init_stack_pool``), with, for a quantized
``kv_dtype``, one K and one V scale tensor of shape ``(L, num_pages, page,
Kv)``, so a copy-on-write page copy is a single ``pool[:, dst] =
pool[:, src]`` per tensor and layer ``i`` works on the contiguous views
``pool[i]``. Collected dense caches are a list with one ``{"k", "v",
"pos"}`` ring per layer (``attention.init_kv_cache``), where JAX stacked
them per segment; a Mamba layer's collected state is ``{"conv", "ssm"}``
(``ssm.mamba_apply``), an RG-LRU layer's ``{"conv", "h"}``
(``rglru.rglru_apply``), and the dense decode advances them; a cross
block's is ``{"self": its ring, "ck", "cv"}``, memory's k and v, which the
decode reads. The paged pools hold attention layers only: a recurrent
family and the encoder-decoder are served dense, as in JAX.

A pipeline stage is a slice of ``Stack.layers`` (the counterpart of
``stage_layer_params`` slicing the stacked leaves), applied by
``stack_stage_apply`` with the same per-layer remat as ``stack_forward``.
"""
from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.paged_attention import quant
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
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


def param_kind(kind: str) -> str:
    return "attn" if kind == "local" else kind


def param_groups(cfg: ArchConfig) -> List[Tuple[Tuple[str, ...], int]]:
    """[(unit param-kind pattern, repeats)]: JAX's variant-independent
    storage (``repro.models.stack.param_groups``)."""
    kinds = tuple(param_kind(k) for k in cfg.pattern)
    if len(set(kinds)) == 1:
        return [((kinds[0],), cfg.n_layers)]
    u = len(kinds)
    n, rem = divmod(cfg.n_layers, u)
    groups = [(kinds, n)]
    if rem:
        groups.append((kinds[:rem], 1))
    return groups


class Slot(NamedTuple):
    """Where a layer's leaves sit in JAX's tree: ``stack/g{group}/p{pos}``,
    index ``repeat`` of the stacked leaves."""
    group: int
    pos: int
    repeat: int


def param_layout(cfg: ArchConfig) -> Tuple[Slot, ...]:
    """Each layer's :class:`Slot`: layer ``off_g + r * u + j`` of group g
    (unit length u) is ``g{g}/p{j}`` index r; a homogeneous stack keeps
    every layer in ``g0/p0``, layer i at index i."""
    out: List[Slot] = []
    for gi, (pattern, R) in enumerate(param_groups(cfg)):
        out += [Slot(gi, j, r) for r in range(R) for j in range(len(pattern))]
    return tuple(out)


def check_served(cfg: ArchConfig) -> None:
    """Raise for a mixer pattern the port does not run. Attention stacks
    (with the vision prefix, or as the decoder of an encoder-decoder behind
    the audio frames), pure Mamba stacks and the RG-LRU hybrid (rglru and
    local layers) are served."""
    kinds = set(cfg.pattern)
    attention = (kinds <= {"attn", "local"} or kinds <= {"rglru", "local"}) and cfg.n_heads
    if not (attention or kinds == {"mamba"}):
        raise NotImplementedError(
            f"{cfg.name}: {cfg.pattern} mixers are ROADMAP queue 1 item 4, "
            "'the other families'"
        )


# -------------------------------------------------------------------- blocks
class Block(nn.Module):
    """One decoder layer: norm1 -> mixer (attention, Mamba or RG-LRU) ->
    norm2 -> FFN, the FFN a dense MLP or a MoE (``ffn_kind``); with
    ``ffn_kind`` "none" (Mamba-1) the block is norm1 -> mixer alone, with no
    ``norm2``. A MoE block may hold ``extra_mlp``, one always-on gated MLP
    whose output adds to the routed one: the shared experts and Arctic's
    dense residual FFN, their hidden units concatenated (exact for
    independent gated MLPs, as in JAX). An encoder-decoder's decoder block
    also holds ``norm_x`` -> ``cross``, the cross-attention over the encoder
    output, between the mixer and the FFN."""

    def __init__(self, norm1: Norm,
                 mixer: Union[attn_mod.Attention, ssm_mod.Mamba, rglru_mod.RGLRU],
                 norm2: Optional[Norm] = None, ffn: Union[MLP, moe_mod.MoE, None] = None,
                 extra_mlp: Optional[MLP] = None, norm_x: Optional[Norm] = None,
                 cross: Optional[attn_mod.Attention] = None):
        super().__init__()
        self.norm1, self.mixer, self.norm2, self.ffn = norm1, mixer, norm2, ffn
        self.extra_mlp = extra_mlp
        self.norm_x, self.cross = norm_x, cross

    @classmethod
    def init(cls, cfg: ArchConfig, gen: torch.Generator, dtype, kind: str,
             cross: bool = False) -> "Block":
        dev = gen.device
        norm1 = Norm.init(cfg.norm, cfg.d_model, dev)
        if kind == "mamba":
            mixer = ssm_mod.Mamba.init(gen, cfg.d_model, cfg.d_inner, cfg.ssm_state,
                                       cfg.ssm_conv, dtype)
        elif kind == "rglru":
            mixer = rglru_mod.RGLRU.init(gen, cfg.d_model, cfg.rglru_width or cfg.d_model,
                                         cfg.ssm_conv, dtype)
        else:
            mixer = attn_mod.Attention.init(
                gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, dtype
            )
        xattn = {}
        if cross:
            xattn = dict(norm_x=Norm.init(cfg.norm, cfg.d_model, dev),
                         cross=attn_mod.Attention.init(gen, cfg.d_model, cfg.n_heads,
                                                       cfg.n_kv_heads, cfg.head_dim, dtype))
        if cfg.ffn_kind == "none":
            return cls(norm1, mixer, **xattn)
        norm2 = Norm.init(cfg.norm, cfg.d_model, dev)
        if cfg.ffn_kind == "dense":
            return cls(norm1, mixer, norm2,
                       MLP.init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_gated, dtype), **xattn)
        ffn = moe_mod.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.mlp_gated,
                               dtype)
        extra = cfg.n_shared_experts * cfg.d_ff + (
            cfg.residual_d_ff if cfg.dense_residual else 0
        )
        return cls(norm1, mixer, norm2, ffn,
                   MLP.init(gen, cfg.d_model, extra, cfg.mlp_gated, dtype) if extra else None,
                   **xattn)


class Stack(nn.Module):
    """The layers in order, and ``layout``: each layer's :class:`Slot` in
    JAX's parameter tree (``param_layout``)."""

    def __init__(self, layers: List[Block], layout: Sequence[Slot]):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.layout = tuple(layout)
        if len(self.layout) != len(layers):
            raise ValueError(f"{len(self.layout)} slots for {len(layers)} layers")

    @classmethod
    def init(cls, cfg: ArchConfig, gen: torch.Generator, dtype,
             cross: bool = False) -> "Stack":
        """``cross``: decoder blocks of an encoder-decoder (``Block.norm_x``,
        ``Block.cross``)."""
        check_served(cfg)
        return cls([Block.init(cfg, gen, dtype, kind, cross) for kind in cfg.mixer_kinds()],
                   param_layout(cfg))


def _ffn_apply(
    cfg: ArchConfig, p: Block, x: torch.Tensor
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Residual FFN. Returns (x, aux): aux is a MoE layer's router loss, None
    for a dense layer or one without FFN (JAX's zero, left out of the sums)."""
    if cfg.ffn_kind == "none":
        return x, None
    h = norm_apply(p.norm2, x, cfg.norm)
    if cfg.ffn_kind == "dense":
        return x + mlp_apply(p.ffn, h, cfg.mlp_gated), None
    out, aux = moe_mod.moe_apply(p.ffn, h, top_k=cfg.experts_top_k,
                                 capacity_factor=cfg.capacity_factor, gated=cfg.mlp_gated)
    if p.extra_mlp is not None:
        out = out + mlp_apply(p.extra_mlp, h, cfg.mlp_gated)
    return x + out, aux


def _add_aux(total: Optional[torch.Tensor], aux: Optional[torch.Tensor]):
    """total + aux, where None stands for a dense layer's zero."""
    if aux is None:
        return total
    return aux if total is None else total + aux


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
    masked weights of 0 by its values, so garbage there would become NaN.

    A quantized ``rt.kv_dtype`` ("int8" / "fp8") stores the pools in its
    code dtype and adds ``{"ksc", "vsc"}``, f32 zeros of shape ``(L,
    num_pages, page, Kv)``, one scale per (page slot, kv head): zero scales
    dequantize the null page to exact zeros."""
    for spec in specs:
        if spec.kind not in ("attn", "local"):
            raise NotImplementedError(
                f"paged decode supports attention mixers only, got {spec.kind}"
            )
    store = quant.kv_storage_dtype(rt.kv_dtype, rt.dtype)
    shape = (len(specs), num_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    pools = {
        "k": torch.zeros(shape, dtype=store, device=device),
        "v": torch.zeros(shape, dtype=store, device=device),
    }
    if quant.is_quantized(rt.kv_dtype):
        pools["ksc"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
        pools["vsc"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
    return pools


def _layer_scales(pools: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s scale pools, for a quantized pool; none otherwise."""
    if "ksc" not in pools:
        return {}
    return {"ksc": pools["ksc"][i], "vsc": pools["vsc"][i]}


# --------------------------------------------------------------------- apply
# a recurrent mixer kind's (full-sequence apply, one-token decode)
RECURRENT = {"mamba": (ssm_mod.mamba_apply, ssm_mod.mamba_decode),
             "rglru": (rglru_mod.rglru_apply, rglru_mod.rglru_decode)}


def _layer_apply(
    cfg: ArchConfig, bp: Block, x: torch.Tensor, spec: LayerSpec, rt: Runtime,
    positions: torch.Tensor, causal: bool, collect: bool = False, cache_len: int = 0,
    memory: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[Dict[str, torch.Tensor]]]:
    """One layer: (x, aux, cache). With ``collect`` the cache is an
    attention layer's ring of ``cache_len`` rows, filled from the k/v that
    attention consumed, a Mamba layer's ``{"conv", "ssm"}`` state or an
    RG-LRU layer's ``{"conv", "h"}`` after the last position. A cross
    block given the encoder ``memory`` attends it after the mixer, and
    collects ``{"self": that cache, "ck", "cv"}``: memory's k and v (B, T,
    Kv, hd), as K1 consumed them (JAX's ``memory @ wk``, ``memory @ wv``)."""
    h = norm_apply(bp.norm1, x, cfg.norm)
    cache = None
    if spec.kind in RECURRENT:
        res = RECURRENT[spec.kind][0](bp.mixer, h, collect_state=collect)
        out, cache = res if collect else (res, None)
    else:
        out, kv = attn_mod.attention_apply(
            bp.mixer, h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.head_dim, theta=cfg.rope_theta, window=spec.window,
            causal=causal, positions=positions, collect_kv=collect,
        )
        if collect:
            k = kv["k"]
            cache = attn_mod.fill_kv_cache(
                attn_mod.init_kv_cache(k.shape[0], cache_len, cfg.n_kv_heads,
                                       cfg.head_dim, k.dtype, k.device),
                k, kv["v"], positions,
            )
    x = x + out
    if memory is not None and bp.cross is not None:
        out, ckv = attn_mod.attention_apply(
            bp.cross, norm_apply(bp.norm_x, x, cfg.norm), n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim, theta=cfg.rope_theta,
            memory=memory, collect_kv=collect,
        )
        x = x + out
        if collect:
            cache = {"self": cache, "ck": ckv["k"], "cv": ckv["v"]}
    x, aux = _ffn_apply(cfg, bp, x)
    return x, aux, cache


def _group_apply(cfg, rt, blocks, specs, positions, causal, memory, x):
    total = None
    for bp, spec in zip(blocks, specs):
        x, aux, _ = _layer_apply(cfg, bp, x, spec, rt, positions, causal, memory=memory)
        total = _add_aux(total, aux)
    return x, total


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
    collect_cache: bool = False,
    causal: bool = True,
    cache_specs: Optional[Tuple[LayerSpec, ...]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[List[Dict[str, torch.Tensor]]]]:
    """Full-sequence forward. x: (B, S, d) embedded. Returns (x, aux,
    caches): aux is the sum of the MoE layers' router losses (0 for a dense
    stack), and ``caches`` (with ``collect_cache``, else None) holds one
    cache per layer: an attention layer's ring of
    ``cache_specs[i].cache_len`` rows (default ``specs``), so a prefill can
    size its caches for a longer decode horizon, or a Mamba layer's decode
    state. ``memory`` (B, T, d), an encoder's output, feeds every cross
    block, whose cache is ``{"self", "ck", "cv"}`` (``_layer_apply``).
    Collection is for serving: it runs the layers without remat."""
    check_served(cfg)
    B, S = x.shape[0], x.shape[1]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    layers = list(stack.layers)
    total = None
    caches = None
    if collect_cache:
        cache_specs = specs if cache_specs is None else cache_specs
        caches = []
        for bp, spec, cspec in zip(layers, specs, cache_specs):
            x, aux, cache = _layer_apply(cfg, bp, x, spec, rt, positions, causal,
                                         collect=True, cache_len=cspec.cache_len,
                                         memory=memory)
            total = _add_aux(total, aux)
            caches.append(cache)
    else:
        k = rt.remat_period
        for i in range(0, len(layers), k):
            fn = functools.partial(_group_apply, cfg, rt, layers[i:i + k], specs[i:i + k],
                                   positions, causal, memory)
            x, aux = _remat(rt, fn, x)
            total = _add_aux(total, aux)
    if total is None:
        total = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, total, caches


def _remat(rt: Runtime, fn, x):
    """``fn(x)`` under ``rt.remat``: as is, or checkpointed (``dots`` also
    saves every matmul output)."""
    if rt.remat == "none":
        return fn(x)
    if rt.remat == "full":
        return checkpoint(fn, x, use_reentrant=False)
    return checkpoint(fn, x, use_reentrant=False, context_fn=_save_matmuls)


def write_prefill_to_pool(
    pools: Dict[str, torch.Tensor],
    caches: List[Dict[str, torch.Tensor]],
    table: torch.Tensor,
    page_size: int,
) -> None:
    """Scatter ONE request's collected caches into its block-table pages,
    in place. Each ring's ``pos`` places its rows (pool position = token
    position); invalid positions, and positions past the table's pages, go
    to the null page 0 (a clip would clobber the last real page). Over a
    quantized pool each row is quantized once, by ``attention._write_rows``,
    the same codes and scales as the chunked and decode writes. table: (P,)
    int32 page ids."""
    P = table.shape[0]
    for i, c in enumerate(caches):
        pos = c["pos"]
        page_idx = pos // page_size
        valid = (pos >= 0) & (page_idx < P)
        pid = torch.where(valid, table[page_idx.clamp(0, P - 1).long()], 0).long()
        slot = torch.where(valid, pos % page_size, 0).long()
        sc = _layer_scales(pools, i)
        attn_mod._write_rows(pools["k"][i], pools["v"][i], sc.get("ksc"), sc.get("vsc"),
                             pid, slot, c["k"][0], c["v"][0])


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
            theta=cfg.rope_theta, window=spec.window, **_layer_scales(pools, i),
        )
        x, _ = _ffn_apply(cfg, bp, x)
    return x


def stack_decode(
    cfg: ArchConfig,
    stack: Stack,
    x: torch.Tensor,
    caches,
    t,
    rt: Runtime,
    specs: Tuple[LayerSpec, ...],
    *,
    tables: Optional[torch.Tensor] = None,
    active: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One-token decode. x: (B, 1, d). Caches are written in place.

    Dense (``tables`` None): ``caches`` are the per-layer caches of
    ``stack_forward(collect_cache=True)`` (rings, and Mamba and RG-LRU
    states, whose dicts take the next state; a cross block's ``{"self",
    "ck", "cv"}``, whose token also attends the cached encoder k/v) and
    ``t`` the int position shared by the batch. Paged: ``caches`` are the
    page pools, ``t`` the (B,) per-slot lengths, and each slot decodes at
    its own depth."""
    if tables is None:
        for bp, spec, cache in zip(stack.layers, specs, caches):
            self_c = cache if bp.cross is None else cache["self"]
            hn = norm_apply(bp.norm1, x, cfg.norm)
            if spec.kind in RECURRENT:
                out, nxt = RECURRENT[spec.kind][1](bp.mixer, hn, self_c)
                self_c.update(nxt)
            else:
                out = attn_mod.attention_decode(
                    bp.mixer, hn, self_c, t, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                    head_dim=cfg.head_dim, theta=cfg.rope_theta, window=spec.window,
                )
            x = x + out
            if bp.cross is not None:
                x = x + attn_mod.cross_decode(
                    bp.cross, norm_apply(bp.norm_x, x, cfg.norm), cache["ck"], cache["cv"],
                    n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
                )
            x, _ = _ffn_apply(cfg, bp, x)
        return x
    pools, lengths = caches, t
    if active is None:
        active = torch.ones(lengths.shape, dtype=torch.bool, device=x.device)
    # MoE couples the rows: an inactive row's null-page read must not race
    null_src = (attn_mod.null_writer(tables, lengths, active, pools["k"].shape[2])
                if cfg.ffn_kind == "moe" else None)
    for i, (bp, spec) in enumerate(zip(stack.layers, specs)):
        hn = norm_apply(bp.norm1, x, cfg.norm)
        x = x + attn_mod.attention_decode_paged(
            bp.mixer, hn, pools["k"][i], pools["v"][i], tables, lengths, active,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
            theta=cfg.rope_theta, window=spec.window, null_src=null_src,
            **_layer_scales(pools, i),
        )
        x, _ = _ffn_apply(cfg, bp, x)
    return x


# ------------------------------------------------------------ pipeline stage
def pipeline_incompatibility(cfg: ArchConfig) -> Optional[str]:
    """Why ``cfg`` cannot run the executable pipeline (None = it can): the
    JAX package's rule at tp = 1. Stages slice the layer stack, which needs
    one homogeneous parameter group and a single mixer kind. JAX's tp > 1
    rules come with tensor parallelism inside a stage (ROADMAP queue 1 item
    6); ``launch.train.build_train_pipeline_host`` refuses tp > 1."""
    if len({"attn" if k == "local" else k for k in cfg.pattern}) != 1:
        return "patterned parameter storage (multi-kind layer unit)"
    if len(set(cfg.pattern)) != 1:
        return "mixed mixer kinds in the layer pattern"
    if cfg.is_encdec or cfg.frontend is not None:
        return "encoder-decoder / frontend architectures"
    return None


def check_staged(cfg: ArchConfig) -> None:
    """Raise for a family the port's pipeline stages do not run yet (JAX's
    stages do): MoE, whose router loss the stage's aux would carry, and
    Mamba."""
    what = "MoE" if cfg.ffn_kind == "moe" else "Mamba" if "mamba" in cfg.pattern else None
    if what:
        raise NotImplementedError(
            f"{cfg.name}: {what} inside pipeline stages is not in the PyTorch port yet "
            "(ROADMAP.md queue 1: item 7, the pipeline)"
        )


def stack_stage_apply(
    cfg: ArchConfig,
    layers: Sequence[Block],
    x: torch.Tensor,
    rt: Runtime,
    spec: LayerSpec,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply one pipeline stage's contiguous layers (a slice of
    ``Stack.layers``) to x (B, S, d), at tp = 1. Returns (y, aux); aux is 0
    for the dense families. ``rt.remat`` checkpoints each layer, as JAX's
    ``policy_for(rt.remat)`` wraps its scan body."""
    check_served(cfg)
    check_staged(cfg)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    for bp in layers:
        fn = functools.partial(_group_apply, cfg, rt, [bp], [spec], positions, True, None)
        x, _ = _remat(rt, fn, x)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)
