"""Vocab-chunked cross-entropy head with a hand-written backward.

Counterpart of ``repro.kernels.chunked_ce.ops``. It computes the two
per-position statistics the loss needs, the label logit and the partition
logsumexp, by walking the head matmul over vocab chunks, so only one
(B, S, chunk) tile is ever live:

  forward   online logsumexp over chunks (running max / sum-exp carry) and
            a gather of the label logit; saves only x, w, labels and logz.
  backward  re-scans the chunks: d logits_c = dlogz * softmax_c, folded into
            dx and dw at once; the label one-hot terms are a gather
            (dll * w[labels] into dx) and an ``index_add_`` (dll * x into dw).

Neither direction holds (B, S, V). This is not one of the TPU kernels: the
JAX op computes its products with XLA einsums, and here they are
``torch.matmul`` in f32 on either device.
"""
from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e30


class _ChunkedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, labels, chunk):
        V = w.shape[0]
        C = min(chunk, V)
        xf = x.float()
        m = torch.full(labels.shape, NEG_INF, dtype=torch.float32, device=x.device)
        l = torch.zeros(labels.shape, dtype=torch.float32, device=x.device)
        ll = torch.zeros(labels.shape, dtype=torch.float32, device=x.device)
        lab = labels.long()
        for c0 in range(0, V, C):
            logits = xf @ w[c0:c0 + C].float().T                     # (B, S, c)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            l = l * torch.exp(m - m_new) + torch.exp(logits - m_new[..., None]).sum(-1)
            m = m_new
            inside = (lab >= c0) & (lab < c0 + logits.shape[-1])
            picked = torch.gather(logits, -1, (lab - c0).clamp(0, logits.shape[-1] - 1)[..., None])
            ll = ll + torch.where(inside, picked[..., 0], 0.0)
        logz = m + torch.log(torch.clamp(l, min=1e-30))
        ctx.save_for_backward(x, w, labels, logz)
        ctx.chunk = C
        return ll, logz

    @staticmethod
    def backward(ctx, dll, dlogz):
        x, w, labels, logz = ctx.saved_tensors
        C = ctx.chunk
        V, d = w.shape
        xf = x.float()
        x2 = xf.reshape(-1, d)
        dx = torch.zeros_like(xf)
        dw = torch.empty((V, d), dtype=torch.float32, device=x.device)
        for c0 in range(0, V, C):
            w_c = w[c0:c0 + C].float()
            p = torch.exp(xf @ w_c.T - logz[..., None])
            dlog = dlogz[..., None] * p                               # (B, S, c)
            dx = dx + dlog @ w_c
            dw[c0:c0 + C] = dlog.reshape(-1, dlog.shape[-1]).T @ x2
        lab = labels.long()
        dx = dx + dll[..., None] * w.float()[lab]
        dw.index_add_(0, lab.reshape(-1), (dll[..., None] * xf).reshape(-1, d))
        return dx.to(x.dtype), dw.to(w.dtype), None, None


def chunked_ce(
    x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, chunk: int = 2048
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d); w: (V, d) vocab-major; labels: (B, S) int in [0, V).

    Returns (label_logit (B, S), logz (B, S)), both f32. Matches
    ``ref.chunked_ce_plain`` without ever holding (B, S, V) logits."""
    return _ChunkedCE.apply(x, w, labels, chunk)
