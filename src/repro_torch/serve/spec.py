"""Speculative-decoding drafters for the paged serve engine.

Counterpart of ``repro.serve.spec``, the same code.

Two drafter kinds feed ``ServeEngine``'s batched verify pass
(``models.lm.verify_step_paged`` — the paged-prefill write-then-attend path
at T = k + 1, K6 on the card):

* ``"ngram"`` (default): model-free prompt-lookup drafting. The k proposed
  tokens are the continuation that followed the most recent earlier
  occurrence of the context's final n-gram (longest n first). No second
  model, no extra device state, works for every family and engine mode —
  and it shines exactly where greedy decode is most wasteful: repetitive
  continuations (cycles, boilerplate, copied spans).
* ``"model"``: a paired small config of the SAME family from the config
  registry (:func:`paired_drafter_cfg`), decoded greedily k steps per tick.
  The drafter shares the target's block tables and page geometry — its own
  (smaller) per-layer pools are indexed by the SAME page ids — so the host
  pool accounting is done once, for both models.

Correctness never depends on draft quality: the engine's greedy acceptance
rule only commits a draft token when it EQUALS the target's own argmax at
that position, so a bad draft (or the zero-padding behind a short n-gram
proposal) costs speed, never tokens, and the committed stream is the target
model's own greedy stream.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ArchConfig, reduced

DRAFTER_KINDS = ("ngram", "model")


def ngram_draft(ctx: np.ndarray, k: int, max_n: int = 3) -> np.ndarray:
    """Prompt-lookup proposal: up to ``k`` tokens continuing ``ctx``.

    Scans for the most recent earlier occurrence of the context's final
    n-gram, longest ``n`` first (``n = max_n .. 1``), and proposes the
    tokens that followed it. A match within ``k`` tokens of the end means
    the continuation runs off the context — and also that the tail is
    (locally) periodic with the match distance as its period, so the
    proposal is extended by cycling that tail window instead of being
    truncated. Blind truncation would cap every accepted run on a
    periodic stream at under one period — exactly the streams prompt
    lookup is best at. Returns an empty array when the context never
    repeats — the engine then runs a draft-free verify (T = 1), which is
    exactly one ordinary decode step, so the no-match tick is never
    slower than non-speculative decode by more than the acceptance
    bookkeeping.

    Pure host-side and deterministic in ``ctx`` alone, so the batched ==
    alone guarantee is untouched by drafting.
    """
    ctx = np.asarray(ctx, np.int32).reshape(-1)
    L = len(ctx)
    if k <= 0 or L < 2:
        return np.zeros(0, np.int32)
    for n in range(min(max_n, L - 1), 0, -1):
        pat = ctx[L - n:]
        # candidate starts (most recent first), strictly before the final
        # occurrence so there is always at least one continuation token
        starts = np.flatnonzero(ctx[: L - n] == pat[0])
        for s in starts[::-1]:
            if n == 1 or np.array_equal(ctx[s : s + n], pat):
                cont = ctx[s + n :]
                if len(cont) < k:      # periodic tail: cycle it out to k
                    cont = np.tile(cont, -(-k // len(cont)))
                return cont[:k].astype(np.int32)
    return np.zeros(0, np.int32)


def paired_drafter_cfg(target: ArchConfig, **over) -> ArchConfig:
    """The registry pairing rule: a drafter config of the SAME family as
    ``target``, built by ``configs.base.reduced`` shrunk to a single layer —
    but with the target's own vocabulary kept, because draft tokens must BE
    target tokens (acceptance compares token ids). The mixer pattern, GQA
    ratio, and head layout survive ``reduced``, so the drafter is paged-
    capable whenever the target is and shares the engine's page geometry.
    """
    upd = dict(
        name=target.name + "-draft",
        n_layers=1,
        vocab_size=target.vocab_size,
        frontend_tokens=target.frontend_tokens,
    )
    upd.update(over)
    return reduced(target, **upd)
