"""Dense oracle for the chunked cross-entropy head (counterpart of
``repro.kernels.chunked_ce.ref``).

Materializes the full (B, S, V) logits — exactly the activation the chunked
op exists to avoid; it is the correctness reference only.
"""
from __future__ import annotations

from typing import Tuple

import torch


def chunked_ce_plain(
    x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d); w: (V, d) vocab-major; labels: (B, S) int in [0, V).
    Returns (label_logit (B, S), logz (B, S)), both f32."""
    logits = torch.einsum("bsd,vd->bsv", x.float(), w.float())
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return ll, logz
