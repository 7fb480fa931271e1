"""Top-level model, serving half: embeddings -> decoder stack -> logits.

Counterpart of the paged serving entry points of ``repro.models.lm``.
Parameters are an :class:`LM` module holding the same tree as the JAX
package (``embed/table``, the per-layer blocks, ``final_norm/scale``,
``head/w``); ``checkpoint.convert.params_from_jax`` carries a JAX tree
across, and :func:`init_params` draws a fresh one from a seeded
``torch.Generator`` on the target device.

The paged state is updated in place: pool pages by the attention writes,
``lengths`` by :func:`decode_step_paged`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
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
from repro_torch.models.stack import layer_specs


class LM(nn.Module):
    def __init__(
        self, embed: Embed, stack: stack_mod.Stack, final_norm: Norm,
        head: Optional[Head],
    ):
        super().__init__()
        self.embed, self.stack, self.final_norm, self.head = (
            embed, stack, final_norm, head
        )


def init_params(
    cfg: ArchConfig, *, seed: int = 0, device="cuda", dtype=torch.bfloat16
) -> LM:
    """Random parameters on ``device`` from ``torch.Generator(seed)``: the
    same tree and the same distributions as ``repro.models.init_params``
    (truncated-normal fan-in matrices, 0.02-normal embeddings, unit norm
    scales), not the same bits. Matmul weights are stored at ``dtype``; norm
    scales, the head and a tied embedding table stay f32, as the logits and
    norms read them in f32."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    stack_mod.check_served(cfg)
    embed = Embed.init(
        gen, cfg.vocab_padded, cfg.d_model,
        torch.float32 if cfg.tie_embeddings else dtype,
    )
    stack = stack_mod.Stack.init(cfg, gen, dtype)
    final_norm = Norm.init(cfg.norm, cfg.d_model, gen.device)
    head = None
    if not cfg.tie_embeddings:
        head = Head(dense_init(gen, cfg.d_model, cfg.vocab_padded))
    return LM(embed, stack, final_norm, head)


def _logits(cfg: ArchConfig, params: LM, x: torch.Tensor) -> torch.Tensor:
    x = norm_apply(params.final_norm, x, cfg.norm)
    return logits_apply(params.head, params.embed, x, cfg.tie_embeddings)


def init_paged_state(
    cfg: ArchConfig,
    B: int,
    rt: Runtime,
    *,
    num_pages: int,
    page_size: int,
    max_len: int,
    device="cpu",
) -> Dict[str, Any]:
    """Paged decode state: the KV page pools shared by ``B`` slots, all-zero
    block tables (the null page) until the engine admits a request, and the
    per-slot count of cached tokens."""
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
