"""Token sampling for the paged serve engine.

Counterpart of ``repro.serve.sampling.SamplingPolicy``. Greedy is the argmax
over vocab-masked logits. Temperature sampling draws each token from a
``torch.Generator`` seeded by ``(seed, rid, step)``, so a request's stream
depends only on the request and never on what else shares the batch — the
batched == alone guarantee. It does not reproduce ``jax.random``'s bits.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


def mask_padded_logits(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Mask vocab-padding ids with the dtype's finfo min."""
    if not vocab or vocab >= logits.shape[-1]:
        return logits
    keep = torch.arange(logits.shape[-1], device=logits.device) < vocab
    return torch.where(keep, logits, torch.finfo(logits.dtype).min)


def stream_seed(seed: int, rid: int, step: int) -> int:
    """63-bit generator seed of step ``step`` of request ``rid``'s stream."""
    state = np.random.SeedSequence([seed, rid, step]).generate_state(1, np.uint64)
    return int(state[0]) & ((1 << 63) - 1)


@dataclasses.dataclass(frozen=True)
class SamplingPolicy:
    """temperature 0 = greedy; vocab = true vocab (padding ids masked out);
    seed = engine seed of every per-request stream."""

    temperature: float = 0.0
    vocab: int = 0
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    def greedy_tokens(self, logits: torch.Tensor) -> torch.Tensor:
        return torch.argmax(mask_padded_logits(logits, self.vocab), dim=-1).to(
            torch.int32
        )

    def sample_rows(
        self, logits: torch.Tensor, rids: Sequence[int], steps: Sequence[int]
    ) -> torch.Tensor:
        """One token per row of ``logits`` (R, Vp): row i is step
        ``steps[i]`` of request ``rids[i]``'s stream (rows whose rid is
        negative are inactive slots and get token 0 without a draw)."""
        if self.greedy:
            return self.greedy_tokens(logits)
        probs = torch.softmax(
            mask_padded_logits(logits.float(), self.vocab) / self.temperature, dim=-1
        )
        out = torch.zeros(logits.shape[0], dtype=torch.int32, device=logits.device)
        for i, (rid, step) in enumerate(zip(rids, steps)):
            if rid < 0:
                continue
            gen = torch.Generator(device=logits.device)
            gen.manual_seed(stream_seed(self.seed, rid, step))
            out[i] = torch.multinomial(probs[i], 1, generator=gen)[0]
        return out
