"""The workloads that ``chip_smoke.py`` runs and ``profile_serve.py`` /
``profile_train.py`` profile, each defined once so they cannot drift.

Serving: granite-8b at full width and depth in bf16, random weights from
seed 0; 8 requests with prompts uniform in 128..512 tokens and 64 new tokens
each, greedy; 4 slots, page 16, chunked prefill of 128 tokens, 8 decode
steps per tick, a pool sized by ``EngineConfig.capacity(..., headroom=2.0)``.

Training: gemma3-1b at full width and depth (26 layers, d 1152, 4 query
heads over 1 kv head of hd 256, window 512 on 22 layers, tied vocabulary of
262,144), bf16 compute over f32 masters, AdamW at lr 1e-3, the chunked-CE
head, remat none, batch 4 x seq 2048 from ``DataPipeline(seed=0)``, random
weights from seed 0.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from repro_torch.configs import ArchConfig, get_config
from repro_torch.models import Runtime, init_params
from repro_torch.serve import EngineConfig
from repro_torch.train import TrainConfig


@dataclass(frozen=True)
class ServeWorkload:
    cfg: ArchConfig
    rt: Runtime
    ecfg: EngineConfig
    prompts: List[np.ndarray]
    new_tokens: int
    seed: int

    def params(self, device: str = "cuda"):
        return init_params(self.cfg, seed=self.seed, device=device,
                           dtype=self.rt.dtype)


def granite_serve_workload(seed: int = 0) -> ServeWorkload:
    cfg = get_config("granite-8b")
    new_tokens, slots, page = 64, 4, 16
    ecfg = EngineConfig.capacity(
        512, new_tokens, slots=slots, page_size=page, headroom=2.0, cfg=cfg,
    ).engine(prefill_chunk=128, inner_steps=8, temperature=0.0, seed=seed)
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in rng.randint(128, 513, size=8)]
    return ServeWorkload(cfg, Runtime(dtype=torch.bfloat16), ecfg, prompts,
                         new_tokens, seed)


@dataclass(frozen=True)
class TrainWorkload:
    cfg: ArchConfig
    tc: TrainConfig
    batch: int
    seq: int
    seed: int

    @property
    def tokens_per_step(self) -> int:
        return self.batch * self.seq

    def data(self):
        from repro_torch.data import DataPipeline

        return DataPipeline(self.cfg, self.batch, self.seq, seed=self.seed)


def gemma_train_workload(seed: int = 0) -> TrainWorkload:
    tc = TrainConfig(precision="bf16", remat="none", fused_backward=True, lr=1e-3,
                     log_every=1)
    return TrainWorkload(get_config("gemma3-1b"), tc, batch=4, seq=2048, seed=seed)
