"""Top-level model: embeddings -> (encoder) -> decoder stack -> logits.

Counterpart of the training forward and loss (``forward_hidden``,
``forward``, ``masked_token_ce``, ``loss_fn``), the pipeline's stage
functions (``pipeline_fns``), the whole-prompt prefill and dense decode
(``prefill``, ``init_decode_state``, ``decode_step``) and the paged serving
entry points of ``repro.models.lm``. A vision config's image prefix
(precomputed patch embeddings, ``batch["frontend_embeds"]``) goes ahead of
the text in the training forward, the loss (which drops its rows) and the
prefill (``_decoder_input``); the paged chunk, decode and verify steps see
text only, at positions past the image. An encoder-decoder's frames
(``batch["frontend_embeds"]``, (B, T, d) precomputed audio frame
embeddings) go through the bidirectional encoder (:func:`encode`), whose
output is the memory every decoder block's cross-attention reads; the
prefill keeps it in the state (``state["memory"]``) beside each layer's
cross caches. An audio config without an encoder drops the frames, as JAX
does.
Parameters are an :class:`LM` module holding the same tree as the JAX
package (``embed/table``, the per-layer blocks, ``final_norm/scale``,
``head/w``, and an encoder-decoder's ``enc_stack`` and ``enc_norm``);
``checkpoint.convert.params_from_jax`` carries a JAX tree across, and
:func:`init_params` draws a fresh one from a seeded ``torch.Generator`` on
the target device.

Decode states are updated in place: pool pages and dense rings by the
attention writes, a Mamba layer's ``{"conv", "ssm"}`` and an RG-LRU
layer's ``{"conv", "h"}`` state by its step,
``lengths`` by :func:`decode_step_paged` (not by
:func:`verify_step_paged`, whose caller commits) and ``t`` (a host int, the
position the next token takes) by :func:`decode_step`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.chunked_ce import chunked_ce
from repro_torch.models import attention as attn_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import stack as stack_mod
from repro_torch.models.layers import (
    Embed,
    Head,
    Norm,
    dense_init,
    embed_apply,
    logits_apply,
    norm_apply,
)
from repro_torch.models.runtime import Runtime
from repro_torch.models.stack import LayerSpec, layer_specs


class LM(nn.Module):
    def __init__(
        self, embed: Embed, stack: stack_mod.Stack, final_norm: Norm,
        head: Optional[Head], enc_stack: Optional[stack_mod.Stack] = None,
        enc_norm: Optional[Norm] = None,
    ):
        super().__init__()
        self.embed, self.stack, self.final_norm, self.head = (
            embed, stack, final_norm, head
        )
        self.enc_stack, self.enc_norm = enc_stack, enc_norm


def init_params(
    cfg: ArchConfig, *, seed: int = 0, device="cuda", dtype=torch.bfloat16
) -> LM:
    """Random parameters on ``device`` from ``torch.Generator(seed)``: the
    same tree and the same distributions as ``repro.models.init_params``
    (truncated-normal fan-in matrices, MoE expert stacks among them,
    0.02-normal embeddings, unit norm scales, ``ssm.Mamba.init``,
    ``rglru.RGLRU.init``), not the same bits. Matmul weights (and the conv
    and gate-block weights of Mamba and the RG-LRU) are stored at ``dtype``;
    norm scales, the head, a tied embedding table and the recurrent
    mixers' vectors (Mamba's ``conv_b``, ``dt_bias``, ``A_log``, ``D``; the
    RG-LRU's ``conv_b``, ``bias_a``, ``bias_x``, ``lam``) stay f32, as JAX
    reads them in f32. An encoder-decoder's decoder blocks hold the cross
    attention, and its encoder (``enc_stack``, ``enc_norm``) is drawn
    last, as JAX builds it from ``_encoder_cfg``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    stack_mod.check_served(cfg)
    embed = Embed.init(
        gen, cfg.vocab_padded, cfg.d_model,
        torch.float32 if cfg.tie_embeddings else dtype,
    )
    stack = stack_mod.Stack.init(cfg, gen, dtype, cross=cfg.is_encdec)
    final_norm = Norm.init(cfg.norm, cfg.d_model, gen.device)
    head = None
    if not cfg.tie_embeddings:
        head = Head(dense_init(gen, cfg.d_model, cfg.vocab_padded))
    enc = {}
    if cfg.is_encdec:
        enc = dict(enc_stack=stack_mod.Stack.init(_encoder_cfg(cfg), gen, dtype),
                   enc_norm=Norm.init(cfg.norm, cfg.d_model, gen.device))
    return LM(embed, stack, final_norm, head, **enc)


def _encoder_cfg(cfg: ArchConfig) -> ArchConfig:
    """The encoder's config: ``enc_layers`` attention layers with a dense
    FFN and no frontend (JAX's ``_encoder_cfg``)."""
    return dataclasses.replace(
        cfg, name=cfg.name + "-enc", n_layers=cfg.enc_layers, enc_layers=0,
        pattern=("attn",), ffn_kind="dense", frontend=None,
    )


def encode(cfg: ArchConfig, params: LM, embeds: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """The bidirectional encoder over precomputed frame embeddings (B, T, d),
    cast to the compute dtype, then ``enc_norm``: the memory (B, T, d). Its
    attention is K1 on a CUDA tensor, not causal."""
    enc_cfg = _encoder_cfg(cfg)
    specs = layer_specs(enc_cfg, seq_len=embeds.shape[1])
    x, _, _ = stack_mod.stack_forward(enc_cfg, params.enc_stack, embeds.to(rt.dtype), rt,
                                      specs, causal=False)
    return norm_apply(params.enc_norm, x, cfg.norm)


def _logits(cfg: ArchConfig, params: LM, x: torch.Tensor) -> torch.Tensor:
    x = norm_apply(params.final_norm, x, cfg.norm)
    return logits_apply(params.head, params.embed, x, cfg.tie_embeddings)


# ------------------------------------------------------------------ training
def _decoder_input(
    cfg: ArchConfig, params: LM, batch: Dict[str, torch.Tensor], rt: Runtime
) -> Tuple[torch.Tensor, Optional[torch.Tensor], int]:
    """(x (B, P + S, d), memory, n_prefix): the embedded tokens, behind a
    vision config's image prefix ``batch["frontend_embeds"]`` (B, P, d),
    cast to the compute dtype before the concatenation as in JAX; n_prefix
    = P, the positions that are not text (0 without a frontend). memory is
    an encoder-decoder's encoded frames (:func:`encode`), else None; an
    audio config without an encoder drops its frames."""
    tok = embed_apply(params.embed, batch["tokens"], rt.dtype)
    if cfg.frontend == "vision":
        img = torch.as_tensor(batch["frontend_embeds"]).to(tok.device, rt.dtype)
        return torch.cat([img, tok], dim=1), None, img.shape[1]
    if cfg.is_encdec:
        frames = torch.as_tensor(batch["frontend_embeds"]).to(tok.device)
        return tok, encode(cfg, params, frames, rt), 0
    return tok, None, 0


def forward_hidden(
    cfg: ArchConfig, params: LM, batch: Dict[str, torch.Tensor], rt: Runtime
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward up to (not including) the vocab projection.
    Returns (hidden (B, P + S, d) after the final norm, aux); P is a vision
    config's image prefix (0 otherwise); an encoder-decoder's decoder
    attends its encoded frames."""
    x, memory, _ = _decoder_input(cfg, params, batch, rt)
    specs = layer_specs(cfg, seq_len=x.shape[1], long_variant=rt.long_variant)
    x, aux, _ = stack_mod.stack_forward(cfg, params.stack, x, rt, specs, memory=memory)
    return norm_apply(params.final_norm, x, cfg.norm), aux


def forward(
    cfg: ArchConfig, params: LM, batch: Dict[str, torch.Tensor], rt: Runtime
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward: f32 logits over the full sequence. Returns (logits, aux)."""
    x, aux = forward_hidden(cfg, params, batch, rt)
    return logits_apply(params.head, params.embed, x, cfg.tie_embeddings), aux


Z_LOSS_DEFAULT = 1e-4


def masked_token_ce(
    ll: torch.Tensor, logz: torch.Tensor, labels: torch.Tensor,
    z_loss: float = Z_LOSS_DEFAULT,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xent, z_loss) from per-token (label log-lik, logZ); labels -1 masked."""
    mask = (labels >= 0).float()
    denom = torch.clamp(mask.sum(), min=1.0)
    xent = -(ll * mask).sum() / denom
    zl = z_loss * ((logz ** 2) * mask).sum() / denom
    return xent, zl


def loss_fn(
    cfg: ArchConfig, params: LM, batch: Dict[str, torch.Tensor], rt: Runtime,
    z_loss: float = Z_LOSS_DEFAULT,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy + z-loss + ``router_aux_coef`` x the MoE
    layers' router aux (0 for the dense families). Labels -1 are masked; a
    vision config's labels cover the text only (its image rows are dropped
    before the head).
    ``rt.fused_backward`` picks the vocab-chunked CE head (same loss and
    grads, never (B, S, V) at once) over the dense f32 logits head; kernels
    route by device either way."""
    h, aux = forward_hidden(cfg, params, batch, rt)
    labels = batch["labels"]
    if cfg.frontend == "vision":          # image prefix positions carry no loss
        h = h[:, batch["frontend_embeds"].shape[1]:]
    safe = torch.clamp(labels, min=0)
    if rt.fused_backward:
        w = params.embed.table if cfg.tie_embeddings else params.head.w.T
        lab, logz = chunked_ce(h, w, safe, rt.ce_chunk)
        ll = lab - logz
    else:
        logits = logits_apply(params.head, params.embed, h, cfg.tie_embeddings)
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, safe.long()[..., None])[..., 0] - logz
    xent, zl = masked_token_ce(ll, logz, labels, z_loss)
    total = xent + zl + cfg.router_aux_coef * aux
    return total, {"loss": total, "xent": xent, "aux": aux, "z_loss": zl}


# ---------------------------------------------------------------- pipeline
def pipeline_shared(params: LM) -> Dict[str, Any]:
    """The parameters every pipeline stage may read: the embedding, the final
    norm and the head (None when tied), as ``pipeline_fns`` takes them."""
    return {"embed": params.embed, "final_norm": params.final_norm, "head": params.head}


def pipeline_fns(cfg: ArchConfig, rt: Runtime):
    """(first_fn, stage_fn, last_fn) for ``core.pipeline.pipeline_grads_host``.

    first_fn(shared, mb) embeds the microbatch's tokens; stage_fn(layers, x)
    applies a stage's slice of ``Stack.layers`` (``stack_stage_apply``) and
    returns the router-aux term (0 for the dense families); last_fn(shared,
    y, mb) is the final norm, the dense f32 logits head and the masked cross
    entropy with z-loss, per microbatch as ``loss_fn``'s dense path. The
    chunked-CE head is not a pipeline head, in JAX either. ``shared`` is
    :func:`pipeline_shared`'s dict.

    The step's loss is the mean of the microbatches' masked means (each
    microbatch weighs the same, whatever its count of valid labels), as in
    JAX.
    """
    why = stack_mod.pipeline_incompatibility(cfg)
    if why is not None:
        raise ValueError(f"{cfg.name}: {why}")
    stack_mod.check_staged(cfg)
    kind = cfg.pattern[0]
    spec = LayerSpec(kind, cfg.sliding_window if kind == "local" else 0, 0)

    def first_fn(shared: Dict[str, Any], mb: Dict[str, torch.Tensor]) -> torch.Tensor:
        return embed_apply(shared["embed"], mb["tokens"], rt.dtype)

    def stage_fn(layers, x: torch.Tensor):
        y, aux = stack_mod.stack_stage_apply(cfg, layers, x, rt, spec)
        return y, cfg.router_aux_coef * aux

    def last_fn(shared: Dict[str, Any], y: torch.Tensor, mb: Dict[str, torch.Tensor]):
        h = norm_apply(shared["final_norm"], y, cfg.norm)
        logits = logits_apply(shared["head"], shared["embed"], h, cfg.tie_embeddings)
        labels = mb["labels"]
        safe = torch.clamp(labels, min=0)
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, safe.long()[..., None])[..., 0] - logz
        xent, zl = masked_token_ce(ll, logz, labels)
        return xent + zl, {"xent": xent, "z_loss": zl}

    return first_fn, stage_fn, last_fn


# ------------------------------------------------------------------- serving
def prefill(
    cfg: ArchConfig,
    params: LM,
    batch: Dict[str, torch.Tensor],
    rt: Runtime,
    max_len: Optional[int] = None,
    gather_pos: Optional[int] = None,
    full_cache: bool = False,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Forward over the prompt (behind a vision config's image prefix);
    returns the f32 logits (B, V) of one position and the dense decode state
    ``{"caches", "t"}``. Positions, ``gather_pos``, the caches and ``t``
    count the image's P positions ahead of the text. An encoder-decoder's
    state also holds ``memory``, the encoded frames, and each layer's cache
    is ``{"self", "ck", "cv"}`` (the cross caches hold memory's k and v);
    the frames are no decoder positions.

    ``max_len`` sizes the rings for the decode horizon (default the prompt
    length); a Mamba or RG-LRU layer's state is O(1) whatever it is. ``gather_pos``
    picks the position whose logits are returned (default the last): a
    prompt right-padded to a bucket gathers its true last position.
    ``full_cache`` sizes every attention ring, sliding-window ones too, to
    the horizon, as the page pool keeps every position. The final norm and
    the head run on that one row."""
    x, memory, _ = _decoder_input(cfg, params, batch, rt)
    S = x.shape[1]
    specs = layer_specs(cfg, seq_len=S, long_variant=rt.long_variant)
    cache_specs = layer_specs(cfg, seq_len=max_len or S, long_variant=rt.long_variant)
    if full_cache:
        cache_specs = tuple(s._replace(cache_len=max_len or S)
                            if s.kind in ("attn", "local") else s for s in cache_specs)
    x, _, caches = stack_mod.stack_forward(
        cfg, params.stack, x, rt, specs, memory=memory, collect_cache=True,
        cache_specs=cache_specs,
    )
    i = S - 1 if gather_pos is None else gather_pos
    logits = _logits(cfg, params, x[:, i: i + 1].contiguous())
    state = {"caches": caches, "t": S}
    if memory is not None:
        state["memory"] = memory
    return logits[:, 0], state


def init_decode_state(
    cfg: ArchConfig, params: LM, B: int, seq_len: int, rt: Runtime
) -> Dict[str, Any]:
    """Empty rings sized for a ``seq_len`` context (and zero Mamba and RG-LRU states),
    on the parameters' device, at position ``seq_len - 1`` (the dry-run /
    bench entry). An encoder-decoder's caches add zero cross caches and its
    state a zero memory, ``frontend_tokens`` rows each."""
    dev = params.embed.table.device
    specs = layer_specs(cfg, seq_len=seq_len, long_variant=rt.long_variant)
    caches = [
        ssm_mod.init_mamba_state(bp.mixer, B, rt.dtype) if s.kind == "mamba" else
        rglru_mod.init_rglru_state(bp.mixer, B, rt.dtype) if s.kind == "rglru" else
        attn_mod.init_kv_cache(B, s.cache_len, cfg.n_kv_heads, cfg.head_dim, rt.dtype, dev)
        for s, bp in zip(specs, params.stack.layers)
    ]
    state: Dict[str, Any] = {"caches": caches, "t": seq_len - 1}
    if cfg.is_encdec:
        T = cfg.frontend_tokens
        cross = (B, T, cfg.n_kv_heads, cfg.head_dim)
        state["caches"] = [
            {"self": c, "ck": torch.zeros(cross, dtype=rt.dtype, device=dev),
             "cv": torch.zeros(cross, dtype=rt.dtype, device=dev)} for c in caches]
        state["memory"] = torch.zeros((B, T, cfg.d_model), dtype=rt.dtype, device=dev)
    return state


def decode_step(
    cfg: ArchConfig,
    params: LM,
    state: Dict[str, Any],
    token: torch.Tensor,
    rt: Runtime,
    seq_len: int,
) -> torch.Tensor:
    """One dense decode step at ``state["t"]`` for the whole batch. token:
    (B,) ids. Returns f32 logits (B, V); writes the rings, steps the Mamba
    and RG-LRU states and advances ``state["t"]`` in place. An
    encoder-decoder's token also attends each layer's cross caches."""
    specs = layer_specs(cfg, seq_len=seq_len, long_variant=rt.long_variant)
    x = embed_apply(params.embed, token[:, None], rt.dtype)
    x = stack_mod.stack_decode(cfg, params.stack, x, state["caches"], state["t"], rt, specs)
    state["t"] += 1
    return _logits(cfg, params, x)[:, 0]


def init_paged_state(
    cfg: ArchConfig,
    B: int,
    rt: Runtime,
    *,
    num_pages: int,
    page_size: int,
    max_len: int,
    device,
) -> Dict[str, Any]:
    """Paged decode state: the KV page pools shared by ``B`` slots (in the
    storage dtype of ``rt.kv_dtype``, with scale pools when it is quantized),
    all-zero block tables (the null page) until the engine admits a request,
    and the per-slot count of cached tokens."""
    specs = layer_specs(cfg, seq_len=max_len, long_variant=rt.long_variant)
    table_width = -(-max_len // page_size)
    return {
        "caches": stack_mod.init_stack_pool(
            cfg, rt, specs, num_pages, page_size, device=device
        ),
        "tables": torch.zeros((B, table_width), dtype=torch.int32, device=device),
        "lengths": torch.zeros((B,), dtype=torch.int32, device=device),
    }


def prefill_chunk_paged(
    cfg: ArchConfig,
    params: LM,
    caches: Dict[str, torch.Tensor],
    table_row: torch.Tensor,
    tokens: torch.Tensor,
    start: int,
    q_len: int,
    rt: Runtime,
    max_len: int,
) -> torch.Tensor:
    """Prefill ONE chunk of one request's prompt into the paged pool.

    tokens: (T,) chunk ids, right-padded past ``q_len``; table_row: (P,)
    int32; ``start`` the absolute position of tokens[0]. Returns the f32
    logits (V,) at the chunk's last valid row; the pool is written in place.
    """
    dev = tokens.device
    specs = layer_specs(cfg, seq_len=max_len, long_variant=rt.long_variant)
    x = embed_apply(params.embed, tokens[None], rt.dtype)               # (1, T, d)
    st = torch.tensor([start], dtype=torch.int32, device=dev)
    ql = torch.tensor([q_len], dtype=torch.int32, device=dev)
    x = stack_mod.stack_prefill_paged(
        cfg, params.stack, x, caches, table_row[None], st, ql, rt, specs,
    )
    return _logits(cfg, params, x[:, q_len - 1: q_len])[0, 0]


def decode_step_paged(
    cfg: ArchConfig,
    params: LM,
    state: Dict[str, Any],
    token: torch.Tensor,
    rt: Runtime,
    max_len: int,
    active: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One paged decode step; each slot advances at its own position.

    token: (B,) ids. Inactive slots neither write the pool nor advance
    ``lengths``; their logits are garbage. Returns f32 logits (B, V) and
    advances ``state["lengths"]`` in place."""
    specs = layer_specs(cfg, seq_len=max_len, long_variant=rt.long_variant)
    lengths = state["lengths"]
    if active is None:
        active = torch.ones(lengths.shape, dtype=torch.bool, device=lengths.device)
    x = embed_apply(params.embed, token[:, None], rt.dtype)
    x = stack_mod.stack_decode(
        cfg, params.stack, x, state["caches"], lengths, rt, specs,
        tables=state["tables"], active=active,
    )
    logits = _logits(cfg, params, x)[:, 0]
    lengths += active.to(lengths.dtype)
    return logits


def verify_step_paged(
    cfg: ArchConfig,
    params: LM,
    state: Dict[str, Any],
    tokens: torch.Tensor,
    q_len: torch.Tensor,
    rt: Runtime,
    max_len: int,
) -> torch.Tensor:
    """Batched multi-token verify pass of speculative decoding.

    tokens: (B, T) ids — per slot, the pending token followed by the k draft
    tokens (T = k + 1), at absolute positions ``lengths[b] .. lengths[b] +
    T - 1``; q_len: (B,) int32 valid rows a slot (0 disables a slot: its rows
    write the null page). Returns the f32 logits (B, T, V); rows at or past
    a slot's ``q_len`` are garbage.

    This is the chunked prefill's write-then-attend path at T = k + 1 (K6 on
    the card), so row t attends exactly positions ``<= lengths + t``, the
    band a sequential decode step there would see. Rejected rows need no
    rollback on the device: their KV lies past the committed length, is
    never attended there, and is overwritten before any later attend.
    ``lengths`` is NOT advanced: the caller commits the accepted run."""
    specs = layer_specs(cfg, seq_len=max_len, long_variant=rt.long_variant)
    x = embed_apply(params.embed, tokens, rt.dtype)                       # (B, T, d)
    x = stack_mod.stack_prefill_paged(
        cfg, params.stack, x, state["caches"], state["tables"], state["lengths"],
        q_len, rt, specs,
    )
    return _logits(cfg, params, x)
