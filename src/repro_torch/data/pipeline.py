"""Deterministic synthetic LM data pipeline with background prefetch.

A copy of ``repro.data.pipeline`` (the port imports nothing of ``repro``):
at equal seeds its batches are bitwise those of the JAX package.

Generates structured synthetic token streams (not uniform noise — a learnable
mixture of Markov chains with per-example transition tables) so training
losses decrease measurably: the end-to-end examples use the loss curve as the
correctness signal. Frontend-equipped architectures (audio/vlm) get matching
stub embeddings derived deterministically from the same seed.

Host sharding: ``DataPipeline(..., shard=(i, n))`` yields the i-th of n
disjoint streams — the per-host pipeline of a multi-host deployment
(a multi-host launcher passes its rank and world size).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig


class MarkovLM:
    """Per-stream vocabulary-restricted Markov chain (order 1)."""

    def __init__(self, vocab: int, seed: int, n_states: int = 64):
        rng = np.random.RandomState(seed)
        self.n_states = n_states
        self.vocab = vocab
        # each state emits from a small token subset; transitions are sparse
        self.emit = rng.randint(0, vocab, size=(n_states, 8))
        self.trans = rng.randint(0, n_states, size=(n_states, 4))
        self._rng = rng

    def sample(self, length: int) -> np.ndarray:
        rng = self._rng
        out = np.empty(length, np.int32)
        s = rng.randint(self.n_states)
        for i in range(length):
            out[i] = self.emit[s, rng.randint(8)]
            s = self.trans[s, rng.randint(4)]
        return out


class DataPipeline:
    def __init__(
        self,
        cfg: ArchConfig,
        batch_size: int,
        seq_len: int,
        seed: int = 0,
        shard: Tuple[int, int] = (0, 1),
        prefetch: int = 2,
    ):
        self.cfg = cfg
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.shard = shard
        base_seed = seed * 1000 + shard[0]
        self._chains = [
            MarkovLM(cfg.vocab_size, base_seed * 97 + i) for i in range(batch_size)
        ]
        self._emb_rng = np.random.RandomState(base_seed + 7)
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _make_batch(self) -> Dict[str, np.ndarray]:
        toks = np.stack([c.sample(self.seq_len + 1) for c in self._chains])
        batch = {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        if self.cfg.frontend is not None:
            batch["frontend_embeds"] = self._emb_rng.randn(
                self.batch_size, self.cfg.frontend_tokens, self.cfg.d_model
            ).astype(np.float32)
        return batch

    def _producer(self):
        while not self._stop.is_set():
            batch = self._make_batch()
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
