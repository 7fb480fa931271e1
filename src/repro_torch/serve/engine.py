"""Continuous-batching serve engine over the paged KV pool, with
whole-prompt or chunked prefill and the radix prefix cache, and the dense
fallback.

Counterpart of ``repro.serve.engine``. A fixed number of decode *slots* is
fed from a QoS/FIFO scheduler. With ``prefill_chunk`` 0 and no prefix cache
(the default) a request is admitted by one whole-prompt prefill
(``lm.prefill`` with full-horizon caches, the prompt right-padded to a
multiple of ``prefill_bucket``), whose collected K/V is scattered into the
slot's pages (``stack.write_prefill_to_pool``); its first token is sampled
there. Otherwise an admitted request adopts its longest cached prompt prefix
(prefix cache on) and is then prefilled in chunks of
``EngineConfig.chunk_tokens``; one engine tick runs one prefill chunk for
the oldest prefilling slot, then ``inner_steps`` decode steps for every
decoding slot — each slot at its own depth. The host only intervenes
between ticks to retire finished requests and admit new ones.

``paged=False`` is the dense fallback: a tick pops the head request and the
queued ones of its (prompt length, max_new) shape, up to ``max_slots``, and
runs them as one ``serve.dense.generate_dense`` batch over ring caches (and
Mamba or RG-LRU states). ``paged=None`` picks the paged engine where every
mixer keeps a KV cache (``paged_supported``) and the dense fallback
otherwise: the SSM family and the RG-LRU hybrid, whose decode state is not
(all) a KV cache, and the encoder-decoder, whose cross caches have no pool,
are served dense, and ``paged=True`` on them raises ``ValueError``, as in
JAX. A ``kv_dtype`` changes nothing on the dense path.

Where JAX ran one jitted program with a ``lax.scan`` over the decode steps
and donated the pool buffers, this engine runs a Python loop and writes the
pools in place. Slot control (``lengths``, ``remaining``, sample steps) is
mirrored on the host, so a tick needs one host copy of the emitted tokens
and no other synchronisation; a request's first token is read back when its
last prompt chunk ends (its TTFT).

Each request's sample stream depends only on (seed, rid, step), so engine
output equals running the request alone. On a CUDA device every paged
attention call goes through K5/K6, every whole-prompt attention through K1
and every RMSNorm through K3; ``stats["kernel_launches"]`` counts their
launches in the run window.

The pool's dtype is ``EngineConfig.kv_dtype`` (else the runtime's), as in
the JAX engine: "bf16" keeps the pools at the compute dtype; "int8" and
"fp8" store codes and one f32 scale per (page slot, kv head), each K/V row
quantized once when it is written, and K5/K6 dequantize inside their
gathers. Scales are indexed by page id like the codes, so the pool's
allocator, copy-on-write copies and the prefix cache's adoption carry them
unchanged.

With ``EngineConfig.spec_tokens = k`` (greedy only) a decode tick is
speculative: a drafter proposes k tokens a slot (prompt lookup,
``serve.spec.ngram_draft``, or a paired small model decoded k steps over
its own pools through the target's block tables), and one batched verify
pass (``lm.verify_step_paged``, K6 at T = k + 1) scores every slot's
pending token and drafts. The leading drafts that equal the target's argmax
chain commit with the verify pass's own next token, 1..k+1 tokens a slot a
tick; each is the target's own argmax, so the stream is the spec-off
stream. Rejected rows need no rollback on the device; under the optimistic
policy ``PagePool.truncate`` hands back the pages they no longer need. A
tick in which a slot is still prefilling in chunks runs the ordinary decode
steps instead.

A MoE config is served like the dense ones, and its router's expert
capacity counts every row of a call: a decode step's inactive rows and a
padded or chunked prompt's rows change which slots the active rows keep. So
the engine feeds the rows JAX's engine feeds (an emptied slot keeps its last
token, with table and length 0), and warns, as JAX does, that bucketed or
chunked prefill (``prefill_bucket``, ``prefill_chunk``, the prefix cache) is
not token-exact against an exact-shape run; ``batched == alone`` does not
hold for MoE either.

A vision config's request carries its image prefix (``submit``'s
``frontend_embeds``, (P, d) precomputed patch embeddings) and occupies P +
its text's tokens in the pool (``_prompt_total``). As in JAX it is always
admitted whole, under the prefix cache or chunked prefill too: the radix
key is token ids, which cannot see the image, and the chunk step embeds
text only (``_use_chunked``). Its pages never enter the prefix cache.

An encoder-decoder's request carries its audio frames (``submit``'s
``frontend_embeds``, (frontend_tokens, d) precomputed frame embeddings),
which the encoder reads; they are no decoder positions, so
``_prompt_total`` and the dense KV price leave them out, and the price has
no share for the cross caches, as JAX's ``dense_kv_bytes`` has none. The
dense tick stacks the requests' frames. An audio config without an encoder
(seamless's decoder alone) is served like a text config, paged by default
and admitted whole; frames given to it are dropped, as in JAX.

Not ported yet (each raises ``NotImplementedError`` at construction,
naming its ROADMAP item): meshes and replicated engines.
"""
from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import cuda as fa_cuda
from repro_torch.kernels.paged_attention import cuda as pa_cuda
from repro_torch.kernels.paged_attention.quant import normalize_kv_dtype
from repro_torch.kernels.rmsnorm import cuda as rn_cuda
from repro_torch.models import (
    LM,
    Runtime,
    decode_step_paged,
    init_paged_state,
    prefill,
    prefill_chunk_paged,
    verify_step_paged,
)
from repro_torch.models.stack import check_served, layer_specs, write_prefill_to_pool
from repro_torch.serve.dense import generate_dense
from repro_torch.serve.pool import PagePool, PoolExhausted, kv_page_bytes
from repro_torch.serve.prefix import PrefixCache
from repro_torch.serve.sampling import SamplingPolicy
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.serve.spec import DRAFTER_KINDS, ngram_draft, paired_drafter_cfg


def _launches() -> Dict[str, int]:
    """The launch counters of the serving path's kernels: K5 and K6 by pool
    variant (bf16, int8, fp8), K1 and K3."""
    return {**pa_cuda.LAUNCHES, fa_cuda.FWD: fa_cuda.LAUNCHES[fa_cuda.FWD],
            "rmsnorm_fwd": rn_cuda.LAUNCHES["rmsnorm_fwd"]}


def paged_supported(cfg: ArchConfig) -> bool:
    """Paged decode needs every mixer to be a KV-cache attention kind and no
    cross-attention cache (enc-dec)."""
    return (
        not cfg.is_encdec
        and cfg.n_heads > 0
        and all(k in ("attn", "local") for k in cfg.pattern)
    )


def dense_kv_bytes(cfg: ArchConfig, rt: Runtime, total: int) -> int:
    """Dense per-request cache bytes for a ``total``-token horizon: every
    attention layer holds its whole ``cache_len`` ring (window-sized for
    local layers) at the compute dtype, whatever the request's length, and
    every recurrent layer JAX's rough share of ``4 * d_model`` values."""
    itemsize = torch.empty((), dtype=rt.dtype).element_size()
    specs = layer_specs(cfg, seq_len=total, long_variant=rt.long_variant)
    tokens = sum(s.cache_len for s in specs if s.kind in ("attn", "local"))
    rec = sum(1 for s in specs if s.kind not in ("attn", "local")) * cfg.d_model * 4 * itemsize
    return tokens * cfg.n_kv_heads * cfg.head_dim * 2 * itemsize + rec


SPEC_COUNTERS = ("spec_verify_calls", "spec_drafted_tokens", "spec_accepted_tokens")


def _check_spec(cfg: ArchConfig, engine: "EngineConfig", paged: bool, draft_params) -> None:
    """The JAX engine's refusals of speculative decoding's unsupported
    combinations."""
    if not paged:
        raise ValueError(
            "speculative decoding needs the paged engine (the verify pass is the "
            "paged-prefill path); spec_tokens=0 for dense-fallback families"
        )
    if engine.temperature != 0.0:
        raise ValueError(
            "speculative decoding is greedy-acceptance only: spec_tokens>0 requires "
            "temperature=0.0"
        )
    if engine.spec_drafter not in DRAFTER_KINDS:
        raise ValueError(f"spec_drafter={engine.spec_drafter!r} not in {DRAFTER_KINDS}")
    if engine.spec_drafter != "model":
        return
    if engine.prefix_cache or engine.prefill_chunk:
        raise ValueError(
            "spec_drafter='model' needs the whole-prompt admission (the drafter's "
            "KV is built there); prefix_cache/prefill_chunk admit without it — use "
            "the ngram drafter with those modes"
        )
    if cfg.frontend is not None:
        raise ValueError(
            "spec_drafter='model': modality-prefix embeddings are sized for the "
            "target d_model and cannot feed the reduced drafter — use the ngram "
            "drafter"
        )
    if draft_params is None:
        raise ValueError(
            "spec_drafter='model' needs draft_params (init the paired config from "
            "spec.paired_drafter_cfg(cfg))"
        )


def _later(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not in the PyTorch port yet (ROADMAP.md queue 1: {item})"
    )


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_slots: int = 4        # decode batch width (dense: requests a batch)
    page_size: int = 16       # tokens per KV page
    num_pages: int = 129      # pool size incl. reserved null page 0
    max_len: int = 256        # per-request horizon; block-table width
    inner_steps: int = 8      # decode steps per engine tick
    temperature: float = 0.0
    seed: int = 0
    policy: str = "reserve"   # admission policy (see serve.scheduler)
    # whole-prompt admission pads prompts to a multiple of this (0 = exact
    # length); the chunk width when prefill_chunk is 0 and the prefix cache is on
    prefill_bucket: int = 0
    # radix-tree KV prefix reuse across requests
    prefix_cache: bool = False
    # prompt tokens per prefill chunk, run inside the engine tick
    prefill_chunk: int = 0
    kv_dtype: str = "bf16"    # "bf16" = pools at the compute dtype; "int8" | "fp8"
    max_queue: int = 0        # per-QoS-tier queue bound (0 = unbounded)
    # speculative decoding (greedy only): draft tokens a slot a tick, verified
    # in one batched (k+1)-row pass; 0 = off
    spec_tokens: int = 0
    spec_drafter: str = "ngram"   # "ngram" (prompt lookup) | "model" (draft_params)
    spec_ngram: int = 3       # longest n-gram the prompt-lookup drafter matches

    @property
    def chunk_tokens(self) -> int:
        """Prefill-chunk width (ragged tails are right-padded to this)."""
        return self.prefill_chunk or self.prefill_bucket or self.page_size

    @classmethod
    def capacity(
        cls,
        max_prompt_total: int,
        max_new: int,
        *,
        slots: Optional[int] = None,
        pool_bytes: Optional[int] = None,
        cfg=None,
        page_size: int = 16,
        headroom: float = 1.0,
        kv_dtype: str = "bf16",
        native_itemsize: int = 2,
    ) -> "Capacity":
        """Size a pool for ``slots`` worst-case requests, or the slot count
        for a ``pool_bytes`` budget (exactly one of the two); ``headroom`` > 1
        over-provisions pages. Same arithmetic as the JAX package."""
        if (slots is None) == (pool_bytes is None):
            raise ValueError("pass exactly one of slots= / pool_bytes=")
        if pool_bytes is not None and cfg is None:
            raise ValueError("pool_bytes sizing needs cfg= for byte pricing")
        if pool_bytes is not None and not paged_supported(cfg):
            raise ValueError(f"{cfg.name} keeps no KV pool to price (served dense)")
        horizon = max_prompt_total + max_new
        max_len = -(-horizon // page_size) * page_size
        pages_per_request = max_len // page_size
        page_bytes = 0
        if cfg is not None:
            page_bytes = kv_page_bytes(
                page_size, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers,
                kv_dtype, native_itemsize,
            )
        if slots is not None:
            num_pages = 1 + math.ceil(slots * pages_per_request * headroom)
        else:
            budget_pages = pool_bytes // page_bytes - 1    # null page charged
            per_slot = math.ceil(pages_per_request * headroom)
            slots = max(1, int(budget_pages) // per_slot)
            num_pages = 1 + slots * per_slot
        return Capacity(
            slots=slots, page_size=page_size, max_len=max_len,
            pages_per_request=pages_per_request, num_pages=num_pages,
            bytes_per_token=(page_bytes // page_size if page_bytes else 0),
            page_bytes=page_bytes, pool_bytes=num_pages * page_bytes,
            kv_dtype=kv_dtype,
        )


@dataclasses.dataclass(frozen=True)
class Capacity:
    """Result of :meth:`EngineConfig.capacity`."""

    slots: int
    page_size: int
    max_len: int              # per-request horizon, page-aligned
    pages_per_request: int
    num_pages: int            # pool size INCLUDING the reserved null page 0
    bytes_per_token: int      # KV bytes/token across layers (0 without cfg)
    page_bytes: int
    pool_bytes: int
    kv_dtype: str

    def engine(self, **kw) -> EngineConfig:
        kw.setdefault("kv_dtype", self.kv_dtype)
        return EngineConfig(
            max_slots=self.slots, page_size=self.page_size,
            num_pages=self.num_pages, max_len=self.max_len, **kw,
        )


@dataclasses.dataclass
class _Slot:
    rid: int
    sid: int                  # pool sequence id
    req: Request
    order: int                # admission order (eviction picks the youngest)
    phase: str = "prefill"    # "prefill" while chunks of the prompt remain
    pf_next: int = 0          # next uncomputed prompt position
    t_admit: float = 0.0      # admission wall time


class ServeEngine:
    def __init__(
        self,
        cfg: ArchConfig,
        params: LM,
        rt: Optional[Runtime] = None,
        engine: EngineConfig = EngineConfig(),
        paged: Optional[bool] = None,
        device="cuda",
        draft_params: Optional[LM] = None,
        draft_cfg: Optional[ArchConfig] = None,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ServeEngine runs on the card by default and CUDA is not "
                "available; pass device='cpu' to run the plain versions"
            )
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if paged is None:
            paged = paged_supported(cfg)
        if engine.spec_tokens:
            _check_spec(cfg, engine, paged and paged_supported(cfg), draft_params)
        check_served(cfg)             # the families the port runs, paged or dense
        if paged and not paged_supported(cfg):
            raise ValueError(
                f"{cfg.name}: family {cfg.family!r} has non-KV decode state; "
                "use paged=False (dense fallback)"
            )
        for what, p in (("params", params), ("draft_params", draft_params)):
            if p is not None and p.embed.table.device != self.device:
                raise ValueError(
                    f"{what} on {p.embed.table.device}, engine on {self.device}"
                )
        self.cfg = cfg
        self.params = params
        self.ecfg = engine
        self.paged = paged
        rt = rt if rt is not None else Runtime()
        self.rt = rt.replace(kv_dtype=normalize_kv_dtype(engine.kv_dtype or rt.kv_dtype))
        self._policy = SamplingPolicy(
            temperature=engine.temperature, vocab=cfg.vocab_size, seed=engine.seed
        )
        self.pool = PagePool(engine.num_pages, engine.page_size)
        self.scheduler = Scheduler(policy=engine.policy, max_queue=engine.max_queue)
        self.prefix: Optional[PrefixCache] = (
            PrefixCache(self.pool) if self.paged and engine.prefix_cache else None
        )
        if self.paged and cfg.ffn_kind == "moe" and (
                engine.prefill_bucket or engine.prefix_cache or engine.prefill_chunk):
            warnings.warn(
                f"{cfg.name}: MoE routing counts pad/chunk tokens in its expert "
                "capacity, so bucketed or chunked prefill is not guaranteed "
                "token-exact vs an exact-shape run (attention itself is exact for "
                "MHA/GQA/MQA; see EngineConfig). Identical engine configs remain "
                "deterministic.",
                stacklevel=2,
            )
        self._next_rid = 0
        self._admit_count = 0
        B = engine.max_slots
        self._slots: List[Optional[_Slot]] = [None] * B
        self._outputs: Dict[int, List[int]] = {}
        self._callbacks: Dict[int, Any] = {}   # rid -> on_token(rid, toks, done)
        self._emitted: Dict[int, int] = {}     # tokens DELIVERED per rid
        self._completed_run: set = set()
        self._run_t0: Optional[float] = None
        self.stats: Dict[str, Any] = {"ttft_s": {}, "prefill_s": {}, "kv_bytes": {}}
        if not self.paged:
            return
        # device state: pools, block tables, per-slot lengths, pending token
        self._dev = init_paged_state(
            cfg, B, self.rt, num_pages=engine.num_pages,
            page_size=engine.page_size, max_len=engine.max_len, device=self.device,
        )
        self._tok = torch.zeros(B, dtype=torch.int32, device=self.device)
        # host mirrors of the slot control: no device read inside a tick
        self._len = np.zeros(B, np.int64)
        self._rem = np.zeros(B, np.int64)
        self._steps = np.zeros(B, np.int64)
        self.stats["kv_pool_bytes_per_device"] = self.kv_pool_bytes_per_device()
        if engine.spec_tokens and engine.spec_drafter == "model":
            # the drafter's own pools, indexed by the TARGET's block tables
            # (the same page ids), so the pool accounting is done once; its
            # cached length trails the target's by at most one token
            self._draft_cfg = draft_cfg if draft_cfg is not None else paired_drafter_cfg(cfg)
            self._draft_params = draft_params
            self._draft_policy = SamplingPolicy(vocab=self._draft_cfg.vocab_size)
            self._draft_pools = init_paged_state(
                self._draft_cfg, B, self.rt, num_pages=engine.num_pages,
                page_size=engine.page_size, max_len=engine.max_len, device=self.device,
            )["caches"]
            self._draft_len = np.zeros(B, np.int64)
            self._spec_catchup = np.full(B, -1, np.int64)

    # ------------------------------------------------------------- public
    def submit(
        self,
        tokens: np.ndarray,
        max_new: int,
        frontend_embeds=None,
        qos: str = "interactive",
        on_token=None,
    ) -> int:
        """Enqueue a request; returns its rid. ``frontend_embeds``: a vision
        config's image prefix or an encoder-decoder's audio frames,
        (frontend_tokens, d_model), required there, ignored by an audio
        config without an encoder, and refused by a config without a
        frontend. ``on_token(rid, tokens, done)`` gets each newly
        delivered token batch (``done`` None while streaming, then
        ``"complete"`` / ``"cancelled"`` once). Raises before any engine
        state changes (shape or capacity ValueError, scheduler.QueueFull)."""
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        cfg = self.cfg
        if cfg.frontend == "vision" or cfg.is_encdec:
            want = (cfg.frontend_tokens, cfg.d_model)
            if frontend_embeds is None or tuple(frontend_embeds.shape) != want:
                raise ValueError(
                    f"{cfg.name} needs frontend_embeds of shape {want}, got "
                    f"{None if frontend_embeds is None else tuple(frontend_embeds.shape)}")
            frontend_embeds = torch.as_tensor(frontend_embeds).float().cpu().numpy()
        elif frontend_embeds is not None and cfg.frontend is None:
            raise ValueError(f"{cfg.name} has no modality frontend: no frontend_embeds")
        else:                    # an audio decoder without an encoder drops its frames
            frontend_embeds = None
        req = Request(
            rid=self._next_rid,
            tokens=np.asarray(tokens, np.int32).reshape(-1),
            max_new=int(max_new),
            frontend_embeds=frontend_embeds,
            qos=qos,
            t_submit=time.perf_counter(),
        )
        total = self._prompt_total(req) + req.max_new - 1
        if self.paged and total > self.ecfg.max_len:
            raise ValueError(
                f"request needs {total} tokens > max_len={self.ecfg.max_len}"
            )
        if self.paged and self.pool.pages_for(total) > self.pool.budget:
            raise ValueError(
                f"request needs {self.pool.pages_for(total)} pages "
                f"> pool budget {self.pool.budget}"
            )
        self.scheduler.add(req)            # may raise QueueFull
        self._next_rid += 1
        if on_token is not None:
            self._callbacks[req.rid] = on_token
        return req.rid

    @property
    def busy(self) -> bool:
        """Work pending: queued requests or seated slots (the dense fallback
        seats none between ticks)."""
        return bool(len(self.scheduler) or any(s is not None for s in self._slots))

    def run_begin(self) -> None:
        """Open a measurement window (per-run counters snapshot here)."""
        self._completed_run = set()
        self._run_t0 = time.perf_counter()
        self._run_admit0 = self._admit_count
        self._run_evict0 = self.stats.get("evictions", 0)
        self._run_discard0 = self.stats.get("discarded_tokens", 0)
        self._run_decode_tokens = 0
        self._run_launch0 = _launches()
        self._run_spec0 = {k: self.stats.get(k, 0) for k in SPEC_COUNTERS}

    @torch.no_grad()
    def step(self) -> Dict[str, Any]:
        """ONE engine tick: admit -> top-up -> prefill chunk + decode steps
        -> collect -> retire (dense: one batched generation). An idle engine
        returns ``busy=False``."""
        if not self.busy:
            return {"busy": False, "finished": [], "decoded": 0}
        if self._run_t0 is None:
            self.run_begin()
        if not self.paged:
            return self._step_dense()
        self._admit_free_slots()
        self._topup_or_evict()
        emits = self._device_step()
        self._run_decode_tokens += self._collect(emits)
        finished = self._retire()
        return {"busy": True, "finished": finished, "decoded": int((emits >= 0).sum())}

    def run_finalize(self) -> Dict[int, np.ndarray]:
        """Close the measurement window: per-run throughput/latency stats,
        and {rid: generated tokens} for the requests completed in it."""
        if self._run_t0 is None:
            return {}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - self._run_t0
        discarded = self.stats.get("discarded_tokens", 0) - self._run_discard0
        n_prefill = (self._admit_count - self._run_admit0) - (
            self.stats.get("evictions", 0) - self._run_evict0
        )
        decode_tokens = self._run_decode_tokens
        self.stats["decode_tokens"] = decode_tokens - discarded
        self.stats["wall_s"] = wall
        self.stats["tokens_per_s"] = (
            decode_tokens - discarded + n_prefill
        ) / max(wall, 1e-9)
        self.stats["pool_high_water_pages"] = self.pool.high_water
        if self.ecfg.spec_tokens:
            # accepted drafts over drafted; accepted-per-verify adds the verify
            # pass's own token (the mean committed run a verify, 1..k+1)
            verifies, drafted, acc = (self.stats.get(k, 0) - self._run_spec0[k]
                                      for k in SPEC_COUNTERS)
            self.stats["spec_accept_rate"] = acc / max(drafted, 1)
            self.stats["spec_accepted_per_verify"] = (acc + verifies) / max(verifies, 1)
        self.stats["kernel_launches"] = {
            k: v - self._run_launch0.get(k, 0) for k, v in _launches().items()
        }
        if self.prefix is not None:
            self.stats.update(self.prefix.stats())
        run_rids = sorted(self._completed_run)
        ttfts = [self.stats["ttft_s"][r] for r in run_rids if r in self.stats["ttft_s"]]
        self.stats["run_completed"] = len(run_rids)
        self.stats["run_mean_ttft_s"] = float(np.mean(ttfts)) if ttfts else 0.0
        self._run_t0 = None
        return {rid: np.asarray(self._outputs[rid], np.int32) for rid in run_rids}

    def run(self) -> Dict[int, np.ndarray]:
        """Drain the queue; returns {rid: generated tokens (max_new,)}."""
        self.run_begin()
        while self.busy:
            self.step()
        return self.run_finalize()

    def cancel(self, rid: int) -> bool:
        """Remove a queued request, or stop an in-flight one and free its
        pages. Safe inside an ``on_token`` callback."""
        req = self.scheduler.cancel(rid)
        if req is not None:
            self.stats["cancelled"] = self.stats.get("cancelled", 0) + 1
            self._deliver_done(rid, "cancelled")
            return True
        for slot_id, slot in enumerate(self._slots):
            if slot is None or slot.rid != rid:
                continue
            if self.prefix is not None and self._use_chunked(slot.req) \
                    and slot.phase == "decode":
                n_full = slot.req.prompt_len // self.ecfg.page_size
                self.prefix.insert(
                    slot.req.tokens, self.pool.seq_pages(slot.sid)[:n_full]
                )
            self.pool.free(slot.sid)
            self._clear_slot(slot_id)
            self.stats["cancelled"] = self.stats.get("cancelled", 0) + 1
            self._deliver_done(rid, "cancelled")
            return True
        return False

    def kv_pool_bytes_per_device(self) -> int:
        if not self.paged:
            return 0
        return sum(
            t.numel() * t.element_size() for t in self._dev["caches"].values()
        )

    # -------------------------------------------------- token delivery
    def _deliver(self, rid: int) -> None:
        toks = self._outputs.get(rid)
        if toks is None:
            return
        sent = self._emitted.get(rid, 0)
        if len(toks) <= sent:
            return
        fresh = toks[sent:]
        self._emitted[rid] = len(toks)
        cb = self._callbacks.get(rid)
        if cb is not None:
            cb(rid, list(fresh), None)

    def _deliver_done(self, rid: int, reason: str) -> None:
        self._deliver(rid)
        cb = self._callbacks.pop(rid, None)
        self._emitted.pop(rid, None)
        if cb is not None:
            cb(rid, [], reason)

    # ----------------------------------------------------------- internals
    def _prompt_total(self, req: Request) -> int:
        """Positions a request's prompt occupies: its text, behind a vision
        config's image prefix."""
        extra = self.cfg.frontend_tokens if self.cfg.frontend == "vision" else 0
        return req.prompt_len + extra

    def _use_chunked(self, req: Request) -> bool:
        """The prefix-adopting, chunked admission path; a modality-prefix
        request keeps the whole-prompt prefill (the radix key is token ids
        and cannot see the image; the chunk step embeds text only)."""
        return (bool(self.ecfg.prefix_cache or self.ecfg.prefill_chunk)
                and self.cfg.frontend is None)

    def _kv_bytes_per_page(self) -> int:
        return kv_page_bytes(
            self.ecfg.page_size, self.cfg.n_kv_heads, self.cfg.head_dim,
            self.cfg.n_layers, self.rt.kv_dtype,
            torch.empty((), dtype=self.rt.dtype).element_size(),
        )

    def _set_slot(self, slot_id: int, *, length: int, remaining: int) -> None:
        self._len[slot_id] = length
        self._rem[slot_id] = remaining
        self._dev["lengths"][slot_id] = length

    def _clear_slot(self, slot_id: int) -> None:
        self._dev["tables"][slot_id] = 0
        self._set_slot(slot_id, length=0, remaining=0)
        self._slots[slot_id] = None

    def _write_table(self, slot_id: int, sid: int) -> None:
        row = self.pool.table(sid, self._dev["tables"].shape[1])
        self._dev["tables"][slot_id] = torch.tensor(row, dtype=torch.int32)

    @property
    def _lookahead(self) -> int:
        """Tokens one tick may write a slot: ``inner_steps`` decode steps, or
        the k + 1 verify rows of a speculative tick (written at ``lengths ..
        lengths + k`` however few commit)."""
        if self.ecfg.spec_tokens:
            return max(self.ecfg.inner_steps, self.ecfg.spec_tokens + 1)
        return self.ecfg.inner_steps

    def _admission_headroom(self) -> int:
        """Free pages required beyond a newcomer's reservation under the
        optimistic policy (one tick of page crossings per running request)."""
        if self.ecfg.policy != "optimistic":
            return 0
        n_active = sum(1 for s in self._slots if s is not None)
        if n_active == 0:
            return 0
        per_slot = self._lookahead // self.ecfg.page_size + 1
        return (n_active + 1) * per_slot

    def _admit_free_slots(self) -> None:
        for slot_id, slot in enumerate(self._slots):
            if slot is not None:
                continue
            req = self.scheduler.peek()
            if req is None:
                break
            cached, sid = 0, None
            if self.prefix is not None and self._use_chunked(req):
                cached, pages = self.prefix.match(
                    req.tokens, max_tokens=req.prompt_len - 1
                )
                if cached:
                    # adopt FIRST: the refcount pins the matched pages so
                    # the pre-eviction below can never free them
                    sid = self.pool.adopt(pages, cached)
            headroom = self._admission_headroom()
            cached_pages = cached // self.ecfg.page_size
            if self.prefix is not None:
                reserve = self.scheduler.reserve_tokens(req, self._prompt_total(req))
                shortfall = (
                    self.pool.pages_for(reserve) - cached_pages + headroom
                    - self.pool.free_pages
                )
                if shortfall > 0:
                    self.prefix.evict_until(shortfall)
            popped = self.scheduler.pop_admissible(
                self.pool, self._prompt_total, headroom_pages=headroom,
                cached_pages_of=(lambda r: cached_pages) if sid is not None else None,
            )
            if popped is None:
                if sid is not None:
                    self.pool.free(sid)
                break
            self._admit(slot_id, popped, cached=cached, sid=sid)
        if not any(self._slots) and len(self.scheduler):
            raise RuntimeError(
                "deadlock: empty engine cannot admit the head request "
                "(pool too small for it — submit() should have rejected it)"
            )

    def _admit(self, slot_id: int, req: Request, cached: int, sid: Optional[int]) -> None:
        prompt_total = self._prompt_total(req)
        reserve = self.scheduler.reserve_tokens(req, prompt_total)
        self.stats["prompt_tokens"] = self.stats.get("prompt_tokens", 0) + prompt_total
        if not self._use_chunked(req):
            self._admit_whole(slot_id, req, reserve)
            return
        if self.prefix is not None:
            self.prefix.note_lookup(cached)   # once per admission
        if sid is None:
            sid = self.pool.alloc(reserve)
        else:
            self.pool.ensure(sid, reserve)   # adopted prefix + fresh tail
        self._apply_copies()
        self._write_table(slot_id, sid)
        self._set_slot(slot_id, length=cached, remaining=0)   # not decoding yet
        self._slots[slot_id] = _Slot(
            req.rid, sid, req, self._admit_count, pf_next=cached,
            t_admit=time.perf_counter(),
        )
        self._admit_count += 1

    def _admit_whole(self, slot_id: int, req: Request, reserve: int) -> None:
        """Whole-prompt admission: one prefill of the prompt (its text
        right-padded to a multiple of ``prefill_bucket``, behind a vision
        request's image) with caches over its whole length, the first token
        sampled from its true last position (step 0 of the request's stream;
        the TTFT), the caches scattered into the slot's pages, and the slot
        flipped straight to decode. Padded positions inside the table are
        overwritten by decode before any query attends them; those past it
        land on the null page."""
        sid = self.pool.alloc(reserve)
        t0 = time.perf_counter()
        tokens = req.tokens
        bucket = self.ecfg.prefill_bucket
        if bucket:
            tokens = np.pad(tokens, (0, -len(tokens) % bucket))
        prompt_total = self._prompt_total(req)
        horizon = prompt_total + len(tokens) - req.prompt_len
        batch = {"tokens": torch.from_numpy(tokens[None]).to(self.device)}
        if req.frontend_embeds is not None:
            batch["frontend_embeds"] = torch.from_numpy(req.frontend_embeds[None]).to(
                self.device)
        logits, pstate = prefill(
            self.cfg, self.params, batch, self.rt, max_len=horizon,
            gather_pos=prompt_total - 1, full_cache=True,
        )
        first = int(self._policy.sample_rows(logits, [req.rid], [0])[0])
        now = time.perf_counter()
        self.stats["ttft_s"].setdefault(req.rid, now - req.t_submit)
        self.stats["prefill_s"][req.rid] = now - t0
        self._write_table(slot_id, sid)
        write_prefill_to_pool(self._dev["caches"], pstate["caches"],
                              self._dev["tables"][slot_id], self.ecfg.page_size)
        if self.ecfg.spec_tokens and self.ecfg.spec_drafter == "model":
            # the drafter prefills the same prompt into its own pools through
            # the same table row, level with the target
            _, dstate = prefill(
                self._draft_cfg, self._draft_params, batch, self.rt,
                max_len=horizon, gather_pos=prompt_total - 1, full_cache=True,
            )
            write_prefill_to_pool(self._draft_pools, dstate["caches"],
                                  self._dev["tables"][slot_id], self.ecfg.page_size)
            self._draft_len[slot_id] = prompt_total
            self._spec_catchup[slot_id] = -1
        self._set_slot(slot_id, length=prompt_total, remaining=req.max_new - 1)
        self._tok[slot_id] = first
        self._steps[slot_id] = 1
        self._slots[slot_id] = _Slot(req.rid, sid, req, self._admit_count,
                                     phase="decode", t_admit=t0)
        self._admit_count += 1
        self._outputs[req.rid] = [first]
        self._deliver(req.rid)   # last: a callback may cancel() this slot

    def _topup_or_evict(self) -> None:
        """Make every active slot's pages cover this tick's writes; preempt
        the youngest on exhaustion. The reserve policy reserved the whole
        horizon at admission, so it has nothing to do here."""
        if self.ecfg.policy == "reserve":
            return
        for slot_id, slot in enumerate(self._slots):
            if slot is None:
                continue
            need = int(self._len[slot_id]) + min(int(self._rem[slot_id]), self._lookahead)
            while self._slots[slot_id] is not None:
                try:
                    self.pool.ensure(slot.sid, need)
                    break
                except PoolExhausted:
                    # idle prefix-cache pages go first: evicting cached-but-
                    # unused KV is free, preempting a request discards work
                    if self.prefix is not None:
                        short = (
                            self.pool.pages_for(need)
                            - len(self.pool.seq_pages(slot.sid))
                            - self.pool.free_pages
                        )
                        if self.prefix.evict_until(max(short, 1)) > 0:
                            continue
                    actives = [
                        (s_id, s) for s_id, s in enumerate(self._slots)
                        if s is not None
                    ]
                    if len(actives) == 1:
                        raise   # a lone request frees nothing by preemption
                    self._evict(*max(actives, key=lambda kv: kv[1].order))
            if self._slots[slot_id] is None:
                continue                       # this slot was the victim
            self._apply_copies()
            self._write_table(slot_id, slot.sid)

    def _evict(self, slot_id: int, slot: _Slot) -> None:
        """Recompute-style preemption: free pages, requeue from scratch."""
        self.pool.free(slot.sid)
        if slot.rid in self._outputs:
            self.stats["discarded_tokens"] = (
                self.stats.get("discarded_tokens", 0)
                + len(self._outputs[slot.rid]) - 1
            )
            del self._outputs[slot.rid]
        # a first token never delivered is re-measured after readmission,
        # still from the original submit time
        if self._emitted.get(slot.rid, 0) == 0:
            self.stats["ttft_s"].pop(slot.rid, None)
            self.stats["prefill_s"].pop(slot.rid, None)
        self.scheduler.requeue_front(slot.req)
        self._clear_slot(slot_id)
        self.stats["evictions"] = self.stats.get("evictions", 0) + 1

    def _apply_copies(self) -> None:
        copies = self.pool.drain_copies()
        if not copies:
            return
        src = torch.tensor([c[0] for c in copies], device=self.device)
        dst = torch.tensor([c[1] for c in copies], device=self.device)
        for pool in self._dev["caches"].values():
            pool[:, dst] = pool[:, src]

    def _device_step(self) -> np.ndarray:
        """One prefill chunk for the oldest prefilling slot (if any), then
        the decode steps of every decoding slot. Returns emits (steps, B),
        -1 where a slot emitted nothing."""
        pf = [
            (i, s) for i, s in enumerate(self._slots)
            if s is not None and s.phase == "prefill"
        ]
        if not pf and self.ecfg.spec_tokens:
            # the verify batch spans every slot, so speculative ticks wait
            # until no prompt is chunking; both paths emit the same stream
            return self._spec_step()
        pf_logits = None
        if pf:
            slot_id, slot = min(pf, key=lambda kv: kv[1].order)
            req = slot.req
            T = self.ecfg.chunk_tokens
            start = slot.pf_next
            n = min(T, req.prompt_len - start)
            chunk = np.zeros(T, np.int32)
            chunk[:n] = req.tokens[start: start + n]
            pf_logits = prefill_chunk_paged(
                self.cfg, self.params, self._dev["caches"],
                self._dev["tables"][slot_id],
                torch.from_numpy(chunk).to(self.device), start, n, self.rt,
                self.ecfg.max_len,
            )
            self.stats["prefill_chunks"] = self.stats.get("prefill_chunks", 0) + 1
        emits = self._decode_steps()
        if pf:
            slot.pf_next = start + n
            if slot.pf_next >= req.prompt_len:
                self._finish_prefill(slot_id, slot, pf_logits)
            else:
                self._set_slot(slot_id, length=slot.pf_next, remaining=0)
        return emits

    def _decode_steps(self) -> np.ndarray:
        """Up to ``inner_steps`` decode steps over all slots; slot b is
        active in step i while ``remaining[b] > i`` (prefilling and empty
        slots have remaining 0). Steps in which no slot is active are
        skipped — they would write only the null page."""
        B = self.ecfg.max_slots
        n = int(min(self.ecfg.inner_steps, self._rem.max()))
        if n <= 0:
            return np.full((0, B), -1, np.int32)
        act_host = self._rem[None, :] > np.arange(n)[:, None]            # (n, B)
        acts = torch.from_numpy(act_host).to(self.device)
        rids = [s.rid if s is not None else -1 for s in self._slots]
        tok = self._tok
        emits = []
        for i in range(n):
            active = acts[i]
            logits = decode_step_paged(
                self.cfg, self.params, self._dev, tok, self.rt,
                max_len=self.ecfg.max_len, active=active,
            )
            nxt = self._policy.sample_rows(
                logits,
                [r if a else -1 for r, a in zip(rids, act_host[i])],
                self._steps + i,
            )
            emits.append(torch.where(active, nxt, -1))
            tok = torch.where(active, nxt, tok)
        self._tok = tok
        taken = act_host.sum(axis=0)
        self._len += taken
        self._rem -= taken
        self._steps += taken
        return torch.stack(emits).cpu().numpy()          # the tick's one read

    def _spec_step(self) -> np.ndarray:
        """One speculative tick over the decoding slots: k drafts a slot,
        one verify pass over every slot's [pending, drafts] row run, and the
        commit of the accepted drafts plus the verify pass's own next token.
        Row j's argmax ``g[j]`` is what a sequential greedy decode emits after
        token j of the run; the accepted count ``a`` is the number of leading
        drafts equal to the argmax chain (``d[j] == g[j - 1]``), so committing
        ``g[:c]``, ``c = min(a + 1, remaining)``, is the target's own greedy
        stream whatever the drafts. Returns emits (k + 1, B), -1 where a slot
        emitted nothing; one host read of g and a."""
        ecfg = self.ecfg
        k, B = ecfg.spec_tokens, ecfg.max_slots
        active = np.array([s is not None for s in self._slots]) & (self._rem > 0)
        n_act = int(active.sum())
        if n_act == 0:
            return np.full((0, B), -1, np.int32)
        if ecfg.spec_drafter == "model":
            drafts = self._run_draft(active)
        else:
            host = np.zeros((B, k), np.int32)
            for slot_id, slot in enumerate(self._slots):
                if active[slot_id]:
                    ctx = np.concatenate(
                        [slot.req.tokens, np.asarray(self._outputs[slot.rid], np.int32)])
                    prop = ngram_draft(ctx, k, ecfg.spec_ngram)
                    host[slot_id, :len(prop)] = prop
            drafts = torch.from_numpy(host).to(self.device)
        # row 0 is the pending token (sampled last tick, not yet cached); a
        # junk or zero-padded draft commits only where it IS the argmax
        tokens = torch.cat([self._tok[:, None], drafts], dim=1)
        q_len = torch.from_numpy(np.where(active, k + 1, 0).astype(np.int32)).to(self.device)
        logits = verify_step_paged(self.cfg, self.params, self._dev, tokens, q_len,
                                   self.rt, ecfg.max_len)
        g = self._policy.greedy_tokens(logits)                           # (B, k+1)
        a = torch.cumprod((tokens[:, 1:] == g[:, :-1]).int(), dim=1).sum(dim=1)
        ga = torch.cat([g, a[:, None].int()], dim=1).cpu().numpy()      # the tick's one read
        g, a = ga[:, :-1], ga[:, -1]
        emits = np.full((k + 1, B), -1, np.int32)
        tok = np.zeros(B, np.int32)
        accepted = 0
        for slot_id, slot in enumerate(self._slots):
            if not active[slot_id]:
                continue
            c = int(min(a[slot_id] + 1, self._rem[slot_id]))
            emits[:c, slot_id] = g[slot_id, :c]
            self._len[slot_id] += c
            self._rem[slot_id] -= c
            self._steps[slot_id] += c
            tok[slot_id] = g[slot_id, c - 1]           # the new pending token
            accepted += c - 1
            if ecfg.policy == "optimistic":
                # the pool half of the rollback: hand back the pages the
                # rejected rows no longer need (table rows are rewritten from
                # the pool every tick under this policy)
                self.pool.truncate(slot.sid, int(self._len[slot_id]))
            if ecfg.spec_drafter == "model":
                if c == k + 1:
                    # full accept: the drafter never cached g[k - 1] (it
                    # consumed through its own (k-1)-th emit); force-feed it
                    # next tick, then the new pending token
                    self._spec_catchup[slot_id] = int(g[slot_id, k - 1])
                    self._draft_len[slot_id] = self._len[slot_id] - 1
                else:
                    # partial accept: its accepted prefix is cached; rewind
                    # past the rejected tail (masked by length, overwritten)
                    self._spec_catchup[slot_id] = -1
                    self._draft_len[slot_id] = self._len[slot_id]
        self._tok = torch.from_numpy(tok).to(self.device)
        self._dev["lengths"].copy_(torch.from_numpy(self._len.astype(np.int32)))
        st = self.stats
        st["spec_verify_calls"] = st.get("spec_verify_calls", 0) + n_act
        st["spec_drafted_tokens"] = st.get("spec_drafted_tokens", 0) + n_act * k
        st["spec_accepted_tokens"] = st.get("spec_accepted_tokens", 0) + accepted
        return emits

    def _run_draft(self, active: np.ndarray) -> torch.Tensor:
        """k greedy steps of the paired drafter an active slot; returns its
        proposals (B, k) on the device. The drafter trails the target by at
        most one cached token, so 1-2 known tokens are force-fed first (the
        catch-up token, then the pending one) and it then runs on its own
        argmax: slot b takes ``n_forced - 1 + k`` active steps and proposes
        emits ``n_forced - 1 .. n_forced - 2 + k``. Steps in which no slot is
        active are skipped."""
        k, dev = self.ecfg.spec_tokens, self.device
        catch = self._spec_catchup
        n_forced = np.where(active & (catch >= 0), 2, 1)
        steps = np.arange(k + 1)[:, None]
        act_host = active[None, :] & (steps < (n_forced - 1 + k)[None, :])   # (k+1, B)
        acts = torch.from_numpy(act_host).to(dev)
        pending = torch.from_numpy(steps < n_forced[None, :]).to(dev)       # feed self._tok
        catch_dev = torch.from_numpy(catch.astype(np.int32)).to(dev)
        tok = torch.where(catch_dev >= 0, catch_dev, self._tok)            # step 0's input
        state = {"caches": self._draft_pools, "tables": self._dev["tables"],
                 "lengths": torch.from_numpy(self._draft_len.astype(np.int32)).to(dev)}
        emits = []
        for i in range(k + 1):
            if not act_host[i].any():
                emits.append(tok)                  # a step no slot proposes from
                continue
            inp = tok if i == 0 else torch.where(pending[i], self._tok, tok)
            logits = decode_step_paged(self._draft_cfg, self._draft_params, state, inp,
                                       self.rt, max_len=self.ecfg.max_len, active=acts[i])
            tok = self._draft_policy.greedy_tokens(logits)
            emits.append(tok)
            self.stats["spec_draft_steps"] = self.stats.get("spec_draft_steps", 0) + 1
        idx = torch.from_numpy(n_forced - 1).to(dev)[:, None] + torch.arange(k, device=dev)
        return torch.gather(torch.stack(emits, dim=1), 1, idx)

    def _finish_prefill(self, slot_id: int, slot: _Slot, pf_logits) -> None:
        """Last chunk done: sample the first token (step 0 of the request's
        stream, the request's TTFT) and flip the slot into decode."""
        req = slot.req
        tok0 = self._policy.sample_rows(pf_logits[None], [req.rid], [0])
        first = int(tok0[0])
        now = time.perf_counter()
        self.stats["ttft_s"].setdefault(req.rid, now - req.t_submit)
        self.stats["prefill_s"][req.rid] = now - slot.t_admit
        self._set_slot(slot_id, length=req.prompt_len, remaining=req.max_new - 1)
        self._tok[slot_id] = first
        self._steps[slot_id] = 1
        slot.phase = "decode"
        self._outputs[req.rid] = [first]
        self._deliver(req.rid)   # last: a callback may cancel() this slot

    def _collect(self, emits: np.ndarray) -> int:
        n = 0
        for slot_id, slot in enumerate(self._slots):
            if slot is None or slot.rid not in self._outputs:
                continue        # mid-prefill: no first token sampled yet
            toks = emits[:, slot_id]
            toks = toks[toks >= 0]
            self._outputs[slot.rid].extend(int(t) for t in toks)
            n += len(toks)
            self._deliver(slot.rid)  # may cancel() this slot (early stop)
        return n

    def _retire(self) -> List[int]:
        finished: List[int] = []
        for slot_id, slot in enumerate(self._slots):
            if slot is None or slot.phase == "prefill" or self._rem[slot_id] > 0:
                continue
            self.stats["kv_bytes"][slot.rid] = (
                len(self.pool.seq_pages(slot.sid)) * self._kv_bytes_per_page()
            )
            self._completed_run.add(slot.rid)
            if self.prefix is not None and self._use_chunked(slot.req):
                # full prompt pages go back into the radix tree
                n_full = slot.req.prompt_len // self.ecfg.page_size
                self.prefix.insert(
                    slot.req.tokens, self.pool.seq_pages(slot.sid)[:n_full]
                )
            self.pool.free(slot.sid)
            self._clear_slot(slot_id)
            finished.append(slot.rid)
            self._deliver_done(slot.rid, "complete")
        return finished


    def _step_dense(self) -> Dict[str, Any]:
        """One dense-fallback tick: the head request and every queued request
        of its (prompt_len, max_new) shape, up to ``max_slots``, generate as
        one batch over ring caches (and recurrent states); each row samples
        its own request's stream. Whole outputs are delivered at the end."""
        part = self.scheduler.pop_batch(self.ecfg.max_slots)
        max_new = part[0].max_new
        batch = {"tokens": torch.from_numpy(np.stack([r.tokens for r in part])).to(self.device)}
        if part[0].frontend_embeds is not None:
            batch["frontend_embeds"] = torch.from_numpy(
                np.stack([r.frontend_embeds for r in part])).to(self.device)
        t_call = time.perf_counter()
        out, _, pf_s = generate_dense(
            self.cfg, self.params, batch, self.rt, max_new,
            temperature=self.ecfg.temperature, seed=self.ecfg.seed,
            stream_ids=[r.rid for r in part],
        )
        out = out.cpu().numpy()
        kv = dense_kv_bytes(self.cfg, self.rt, self._prompt_total(part[0]) + max_new)
        finished: List[int] = []
        for b, r in enumerate(part):
            self._outputs[r.rid] = [int(t) for t in out[b]]
            # TTFT from submit: the queue wait before this tick, then the
            # batch's prefill and first sample
            self.stats["ttft_s"][r.rid] = t_call + pf_s - r.t_submit
            self.stats["prefill_s"][r.rid] = pf_s
            self.stats["kv_bytes"][r.rid] = kv
            self._run_decode_tokens += max_new - 1
            self._admit_count += 1
            self._completed_run.add(r.rid)
            finished.append(r.rid)
            self._deliver_done(r.rid, "complete")
        return {"busy": True, "finished": finished, "decoded": len(part) * max_new}


class ReplicatedServeEngine:
    """Data-parallel serving over a mesh: a later slice."""

    def __init__(self, *args, **kwargs):
        raise _later("ReplicatedServeEngine (a mesh of replicas)",
                     "item 6, memory techniques and multi-device")
