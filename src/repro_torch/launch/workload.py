"""The workloads that ``chip_smoke.py`` runs and ``profile_serve.py`` /
``profile_train.py`` profile, each defined once so they cannot drift.

Serving: granite-8b at full width and depth in bf16, random weights from
seed 0; 8 requests with prompts uniform in 128..512 tokens and 64 new tokens
each, greedy; 4 slots, page 16, chunked prefill of 128 tokens, 8 decode
steps per tick, a pool sized by ``EngineConfig.capacity(..., headroom=2.0)``.
``kv_dtype`` "int8" / "fp8" stores that pool as codes and scales: the same
requests, slots, page size, chunk and number of pages, fewer pool bytes.
``granite_serve_whole_workload`` is the same workload admitted by
whole-prompt prefill (``prefill_chunk`` 0, prompts padded to a bucket of
128): one K1 launch a layer an admission, no K6.
``granite_serve_spec_workload`` is that workload with speculative decoding
(``spec_tokens`` 4, the ngram drafter by default): every tick is one verify
pass, one K6 launch a layer, and no K5 unless the drafter is the paired
1-layer model, whose steps run K5.
``qwen3_moe_serve_workload`` serves qwen3-moe-30b-a3b at full width and
depth (48 layers, d 2048, 128 experts top-8 of hidden 768, 32 query heads
over 4 kv heads of hd 128, vocabulary 151,936) in bf16, random weights from
seed 0, with the same requests, slots and page size, admitted whole at exact
shapes (``prefill_bucket`` 0: the router's expert capacity counts pad rows);
its bf16 pool holds 98,304 bytes a token.
``phi3_vision_serve_workload`` serves phi-3-vision-4.2b at full width and
depth (32 layers, d 3072, 32 heads of hd 96 over as many kv heads, d_ff
8192, vocabulary 32,064) in bf16, random weights from seed 0, with the same
text prompts and slots, each behind its own image prefix: a (576, 3072) f32
``randn`` from ``RandomState(seed + 1)`` standing for the projected patch
embeddings. Admitted whole (as every vision request is), text padded to a
bucket of 128, so each prefill runs 704, 832, 960 or 1,088 positions; the
pool is sized for 512 + 576 prompt positions and holds 393,216 bytes a
token.
``falcon_mamba_serve_workload`` serves falcon-mamba-7b at full width and
depth (64 Mamba-1 layers, d 4096, d_inner 8192, state 16, conv 4,
vocabulary 65,024, no attention and no FFN) in bf16, random weights from
seed 0, with serve-whole's eight prompt lengths (the same generator and
seed, its tokens drawn over this vocabulary), 64 new tokens, greedy, 4
slots, on the engine's dense fallback (the SSM's decode state is no KV
cache, so it has no pool to price: ``EngineConfig.capacity`` sizes the
horizon without ``cfg=``). The dense engine batches requests of one prompt
length, so each of the eight runs alone.
``recurrentgemma_serve_workload`` is that workload's shape on
recurrentgemma-2b at full width and depth (26 layers: 18 RG-LRU of width
2,560 and 8 local attention of 10 query heads over 1 kv head of hd 256,
window 2,048; d 2560, gated MLP of 7,680, untied vocabulary of 256,000) in
bf16, random weights from seed 0, dense (the RG-LRU state is no KV cache):
K1 runs once a local layer a prefill, K3 twice a layer and once more a pass.
``seamless_serve_workload`` is that workload's shape on seamless-m4t-medium
at full width and depth (12 encoder and 12 decoder layers, d 1024, 16
heads of hd 64 over as many kv heads, plain MLP of 4,096, LayerNorm,
untied vocabulary of 256,256 padded rows) in bf16, random weights from seed
0, dense (JAX serves an encoder-decoder dense only), each request behind its
own audio frames: a (1024, 1024) f32 ``randn`` from ``RandomState(seed +
1)`` standing for the frame embeddings, drawn as the vision workload's
images are. An admission runs K1 36 times (12 bidirectional encoder
layers over the 1,024 frames, 12 causal decoder self-attentions over the
prompt, 12 cross-attentions from the prompt to the frames) and no K3
(LayerNorm is plain).

Training: gemma3-1b at full width and depth (26 layers, d 1152, 4 query
heads over 1 kv head of hd 256, window 512 on 22 layers, tied vocabulary of
262,144), bf16 compute over f32 masters, AdamW at lr 1e-3, the chunked-CE
head, remat none, batch 4 x seq 2048 from ``DataPipeline(seed=0)``, random
weights from seed 0. ``gemma_train8_workload`` is the same workload with
8-bit Adam (``optimizer="adam8bit"``), whose moments go through the K8
codec every step.

Pipeline training (``granite_pipe_workload``): granite-8b at full width (d
4096, 32 query heads over 8 kv heads of hd 128, d_ff 14,336, untied vocabulary
of 49,152) and 8 of its 36 layers (``dataclasses.replace``; the 36 layers'
f32 masters, AdamW moments and grads do not fit one 80 GB card), bf16 over
f32 masters, AdamW at lr 1e-3, remat none, the dense head, batch 8 x seq 2048
from ``DataPipeline(seed=0)``, random weights from seed 0; P = 4 stages of
2 layers, M = 8 microbatches of 1 x 2048, 1F1B, int8 activation stash,
through ``launch.train.build_train_pipeline_host``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import ArchConfig, get_config
from repro_torch.core.partitioner import ParallelPlan
from repro_torch.kernels.paged_attention.quant import normalize_kv_dtype
from repro_torch.models import Runtime, init_params
from repro_torch.serve import EngineConfig
from repro_torch.train import TrainConfig, plan_fields


@dataclass(frozen=True)
class ServeWorkload:
    cfg: ArchConfig
    rt: Runtime
    ecfg: EngineConfig
    prompts: List[np.ndarray]
    new_tokens: int
    seed: int
    frontend_embeds: Optional[List[np.ndarray]] = None   # one image or frames a prompt

    def image(self, i: int) -> Optional[np.ndarray]:
        """Prompt ``i``'s image prefix or audio frames (None for a text-only
        workload)."""
        return None if self.frontend_embeds is None else self.frontend_embeds[i]

    def params(self, device: str = "cuda"):
        return init_params(self.cfg, seed=self.seed, device=device,
                           dtype=self.rt.dtype)


NEW_TOKENS, SLOTS, PAGE = 64, 4, 16


def _prompts(cfg: ArchConfig, seed: int) -> List[np.ndarray]:
    """8 prompts uniform in 128..512 tokens over ``cfg``'s vocabulary."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, (int(n),)).astype(np.int32)
            for n in rng.randint(128, 513, size=8)]


def _serve_workload(name: str, seed: int, kv_dtype: str, prefill_chunk: int,
                    prefill_bucket: int) -> ServeWorkload:
    cfg = get_config(name)
    ecfg = EngineConfig.capacity(
        512 + cfg.frontend_tokens, NEW_TOKENS, slots=SLOTS, page_size=PAGE, headroom=2.0,
        cfg=cfg, kv_dtype=kv_dtype,
    ).engine(prefill_chunk=prefill_chunk, prefill_bucket=prefill_bucket,
             inner_steps=8, temperature=0.0, seed=seed)
    prompts = _prompts(cfg, seed)
    rt = Runtime(dtype=torch.bfloat16, kv_dtype=normalize_kv_dtype(kv_dtype))
    return ServeWorkload(cfg, rt, ecfg, prompts, NEW_TOKENS, seed,
                         _frontend_embeds(cfg, seed, len(prompts)))


def _frontend_embeds(cfg: ArchConfig, seed: int, n: int) -> Optional[List[np.ndarray]]:
    """One (frontend_tokens, d_model) f32 ``randn`` a request from
    ``RandomState(seed + 1)``: a vision config's image prefixes or an
    encoder-decoder's audio frames; None for a text config."""
    if cfg.frontend is None:
        return None
    rng = np.random.RandomState(seed + 1)
    return [rng.randn(cfg.frontend_tokens, cfg.d_model).astype(np.float32)
            for _ in range(n)]


def granite_serve_workload(seed: int = 0, kv_dtype: str = "bf16",
                           prefill_chunk: int = 128) -> ServeWorkload:
    return _serve_workload("granite-8b", seed, kv_dtype, prefill_chunk,
                           0 if prefill_chunk else 128)


def granite_serve_whole_workload(seed: int = 0, kv_dtype: str = "bf16") -> ServeWorkload:
    return granite_serve_workload(seed, kv_dtype, prefill_chunk=0)


def granite_serve_spec_workload(seed: int = 0, kv_dtype: str = "bf16", spec_tokens: int = 4,
                                drafter: str = "ngram") -> ServeWorkload:
    wl = granite_serve_whole_workload(seed, kv_dtype)
    return replace(wl, ecfg=replace(wl.ecfg, spec_tokens=spec_tokens, spec_drafter=drafter))


def qwen3_moe_serve_workload(seed: int = 0) -> ServeWorkload:
    return _serve_workload("qwen3-moe-30b-a3b", seed, "bf16", 0, 0)


def phi3_vision_serve_workload(seed: int = 0) -> ServeWorkload:
    return _serve_workload("phi-3-vision-4.2b", seed, "bf16", 0, 128)


def _dense_workload(name: str, seed: int) -> ServeWorkload:
    cfg = get_config(name)
    ecfg = EngineConfig.capacity(512, NEW_TOKENS, slots=SLOTS, page_size=PAGE).engine(
        inner_steps=8, temperature=0.0, seed=seed)
    prompts = _prompts(cfg, seed)
    return ServeWorkload(cfg, Runtime(dtype=torch.bfloat16), ecfg, prompts, NEW_TOKENS,
                         seed, _frontend_embeds(cfg, seed, len(prompts)))


def falcon_mamba_serve_workload(seed: int = 0) -> ServeWorkload:
    return _dense_workload("falcon-mamba-7b", seed)


def recurrentgemma_serve_workload(seed: int = 0) -> ServeWorkload:
    return _dense_workload("recurrentgemma-2b", seed)


def seamless_serve_workload(seed: int = 0) -> ServeWorkload:
    return _dense_workload("seamless-m4t-medium", seed)


@dataclass(frozen=True)
class TrainWorkload:
    cfg: ArchConfig
    tc: TrainConfig
    batch: int
    seq: int
    seed: int
    plan: Optional[ParallelPlan] = None      # set: the pipeline trainer

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


def gemma_train8_workload(seed: int = 0) -> TrainWorkload:
    wl = gemma_train_workload(seed)
    return replace(wl, tc=replace(wl.tc, optimizer="adam8bit"))


def granite_pipe_workload(seed: int = 0) -> TrainWorkload:
    plan = ParallelPlan(pp=4, microbatches=8, schedule="1f1b", stash="int8")
    tc = TrainConfig(precision="bf16", lr=1e-3, log_every=1, **plan_fields(plan))
    cfg = replace(get_config("granite-8b"), n_layers=8)
    return TrainWorkload(cfg, tc, batch=8, seq=2048, seed=seed, plan=plan)
