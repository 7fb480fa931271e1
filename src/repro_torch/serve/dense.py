"""Dense (contiguous ring-cache) generation: the ``paged=False`` serving path.

Counterpart of ``repro.serve.dense``. JAX compiled the prefill and one
``lax.scan`` decode loop per shape and cached them; here both are eager
PyTorch, so there is no compile cache and no shape key to port. The prefill
runs K1 over the whole prompt on every attention layer (and K3 on every
norm) on a CUDA tensor; the one-token decode over the rings is plain
PyTorch, as the JAX decode is plain jnp. The recurrent families, which JAX
serves only here, prefill by their scans and decode by their recurrent
steps, both plain PyTorch as in JAX, with K3 on every norm: a Mamba stack
(the SSM family), and the RG-LRU hybrid, whose local-attention layers
prefill through K1 and decode over window-sized rings like any attention
layer. An encoder-decoder, which JAX also serves only here, encodes each
row's frames in the prefill (K1 over the frames, not causal) and runs its
cross-attention there through K1 too; its decode attends the cross caches
in plain PyTorch, as JAX's ``_cross_decode``.

Sampling is the serve engine's ``SamplingPolicy``: greedy, or row b's token
i drawn from the stream ``(seed, stream_ids[b], i)``. The engine passes its
requests' rids, so a request's tokens do not depend on what else shares its
batch. (JAX's dense path shares one key across the batch; its temperature
streams are not reproduced.)
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import LM, Runtime, decode_step, prefill
from repro_torch.serve.sampling import SamplingPolicy


@torch.no_grad()
def generate_dense(
    cfg: ArchConfig,
    params: LM,
    batch: Dict[str, torch.Tensor],
    rt: Runtime,
    max_new_tokens: int,
    temperature: float = 0.0,
    seed: int = 0,
    stream_ids: Optional[Sequence[int]] = None,
) -> Tuple[torch.Tensor, Dict[str, Any], float]:
    """Batched dense generation over equal-length prompts ``batch["tokens"]``
    (B, S) on the parameters' device, behind a vision config's image prefix
    ``batch["frontend_embeds"]`` (B, P, d), which the rings hold too, or
    with an encoder-decoder's frames there (B, T, d), which the horizon
    does not count; a recurrent layer (Mamba, RG-LRU) carries its O(1)
    state instead of a ring.
    Returns (tokens (B, max_new) int32, the final decode state, ttft_s):
    ttft_s is the wall time of the prefill and the first sample, ending in a
    sync of the card."""
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    tokens = batch["tokens"]
    B, S = tokens.shape
    total = S + max_new_tokens
    if cfg.frontend == "vision":
        total += cfg.frontend_tokens
    policy = SamplingPolicy(temperature=temperature, vocab=cfg.vocab_size, seed=seed)
    rows = list(range(B)) if stream_ids is None else list(stream_ids)

    t0 = time.perf_counter()
    logits, state = prefill(cfg, params, batch, rt, max_len=total)
    tok = policy.sample_rows(logits, rows, [0] * B)
    if tok.device.type == "cuda":
        torch.cuda.synchronize(tok.device)
    ttft = time.perf_counter() - t0

    out = [tok]
    for i in range(1, max_new_tokens):
        logits = decode_step(cfg, params, state, tok, rt, seq_len=total)
        tok = policy.sample_rows(logits, rows, [i] * B)
        out.append(tok)
    return torch.stack(out, dim=1), state, ttft
