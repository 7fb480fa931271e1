"""Batched serving API: prefill, then autoregressive decode with sampling.

Counterpart of ``repro.train.serve.generate``, a thin wrapper over the
serving package:

* dense (the default): ``serve.dense.generate_dense``, one batch over ring
  caches (and the recurrent states of Mamba and RG-LRU layers);
* ``paged=True``: the continuous-batching engine, one request per batch row,
  over a pool sized by ``EngineConfig.capacity`` for the batch, admitted by
  whole-prompt prefill. A family with non-KV decode state (the SSM, the
  RG-LRU hybrid) has no pool and raises ``ValueError``, as the engine does.

Both run on the parameters' device, a vision config's batch with its image
prefixes. Greedy outputs are the same on both paths. An encoder-decoder's
batch carries its frames and is served dense only (``paged=True`` raises,
as in JAX).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import LM, Runtime


def generate(
    cfg: ArchConfig,
    params: LM,
    batch: Dict[str, Any],
    rt: Runtime,
    max_new_tokens: int,
    temperature: float = 0.0,
    seed: int = 0,
    paged: bool = False,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Returns (tokens (B, max_new_tokens) int32 on the parameters' device,
    the final dense decode state, or with ``paged=True`` the engine's stats).
    ``batch["tokens"]``: (B, S) ids, a tensor or an array; a vision config's
    ``batch["frontend_embeds"]``: (B, P, d) image prefixes (an
    encoder-decoder's: (B, T, d) frames)."""
    device = params.embed.table.device
    tokens = torch.as_tensor(batch["tokens"]).to(device=device, dtype=torch.int32)
    fe = batch.get("frontend_embeds")
    if paged:
        from repro_torch.serve import EngineConfig, ServeEngine

        B, S = tokens.shape
        prompt_total = S + (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
        eng = ServeEngine(
            cfg, params, rt,
            EngineConfig.capacity(prompt_total, max_new_tokens, slots=B).engine(
                temperature=temperature, seed=seed),
            paged=True, device=device,
        )
        host = tokens.cpu().numpy()
        rids = [eng.submit(host[b], max_new_tokens,
                           frontend_embeds=None if fe is None else fe[b])
                for b in range(B)]
        out = eng.run()
        return torch.as_tensor(np.stack([out[r] for r in rids]), device=device), eng.stats

    from repro_torch.serve.dense import generate_dense

    dense = {"tokens": tokens}
    if fe is not None:
        dense["frontend_embeds"] = torch.as_tensor(fe).to(device=device, dtype=torch.float32)
    out, state, _ = generate_dense(cfg, params, dense, rt, max_new_tokens,
                                   temperature=temperature, seed=seed)
    return out, state
