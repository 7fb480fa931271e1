"""Continuous-batching serve engine over the paged KV pool, with chunked
prefill and the radix prefix cache.

Counterpart of the paged path of ``repro.serve.engine``. A fixed number of
decode *slots* is fed from a QoS/FIFO scheduler. An admitted request adopts
its longest cached prompt prefix (prefix cache on) and is then prefilled in
chunks of ``EngineConfig.chunk_tokens``; one engine tick runs one prefill
chunk for the oldest prefilling slot, then ``inner_steps`` decode steps for
every decoding slot — each slot at its own depth. The host only intervenes
between ticks to retire finished requests and admit new ones.

Where JAX ran one jitted program with a ``lax.scan`` over the decode steps
and donated the pool buffers, this engine runs a Python loop and writes the
pools in place. Slot control (``lengths``, ``remaining``, sample steps) is
mirrored on the host, so a tick needs one host copy of the emitted tokens
and no other synchronisation; a request's first token is read back when its
last prompt chunk ends (its TTFT).

Each request's sample stream depends only on (seed, rid, step), so engine
output equals running the request alone. On a CUDA device every attention
call goes through the hand-written paged kernels and every RMSNorm through
K3; ``stats["kernel_launches"]`` counts their launches in the run window.

Not in this slice (each raises ``NotImplementedError`` naming its ROADMAP
item): the dense fallback (``paged=False`` and the non-attention families),
whole-prompt admission (``prefill_chunk=0`` with ``prefix_cache=False``),
speculative decoding, quantized KV pools, meshes and replicated engines,
and modality-prefix configs.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.paged_attention import cuda as pa_cuda
from repro_torch.kernels.rmsnorm import cuda as rn_cuda
from repro_torch.models import (
    LM,
    Runtime,
    decode_step_paged,
    init_paged_state,
    prefill_chunk_paged,
)
from repro_torch.serve.pool import PagePool, PoolExhausted, kv_page_bytes
from repro_torch.serve.prefix import PrefixCache
from repro_torch.serve.sampling import SamplingPolicy
from repro_torch.serve.scheduler import Request, Scheduler


def _launches() -> Dict[str, int]:
    """The launch counters of the serving path's kernels (K5, K6, K3)."""
    return {**pa_cuda.LAUNCHES, "rmsnorm_fwd": rn_cuda.LAUNCHES["rmsnorm_fwd"]}


def paged_supported(cfg: ArchConfig) -> bool:
    """Paged decode needs every mixer to be a KV-cache attention kind and no
    cross-attention cache (enc-dec)."""
    return (
        not cfg.is_encdec
        and cfg.n_heads > 0
        and all(k in ("attn", "local") for k in cfg.pattern)
    )


def _later(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not in the PyTorch port yet (ROADMAP.md queue 1: {item})"
    )


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_slots: int = 4        # decode batch width
    page_size: int = 16       # tokens per KV page
    num_pages: int = 129      # pool size incl. reserved null page 0
    max_len: int = 256        # per-request horizon; block-table width
    inner_steps: int = 8      # decode steps per engine tick
    temperature: float = 0.0
    seed: int = 0
    policy: str = "reserve"   # admission policy (see serve.scheduler)
    # chunk width when prefill_chunk is 0 and the prefix cache is on
    prefill_bucket: int = 0
    # radix-tree KV prefix reuse across requests
    prefix_cache: bool = False
    # prompt tokens per prefill chunk, run inside the engine tick
    prefill_chunk: int = 0
    kv_dtype: str = "bf16"    # "bf16" = pools at the compute dtype
    max_queue: int = 0        # per-QoS-tier queue bound (0 = unbounded)
    spec_tokens: int = 0      # speculative decoding: a later slice

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
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ServeEngine runs on the card by default and CUDA is not "
                "available; pass device='cpu' to run the plain versions"
            )
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if paged is False or not paged_supported(cfg):
            raise _later(f"{cfg.name}: the dense fallback (paged=False)",
                         "the dense fallback and the other families")
        if cfg.frontend is not None:
            raise _later(f"{cfg.name}: modality-prefix configs",
                         "the other families")
        if not (engine.prefix_cache or engine.prefill_chunk):
            raise _later("whole-prompt admission (prefill_chunk=0 without "
                         "prefix_cache)", "the training step and whole-prompt prefill")
        if engine.spec_tokens:
            raise _later("speculative decoding (spec_tokens>0)",
                         "speculative decoding")
        if engine.kv_dtype not in ("", "bf16", "native"):
            raise _later(f"kv_dtype={engine.kv_dtype!r}", "quantized KV")
        if params.embed.table.device != self.device:
            raise ValueError(
                f"params on {params.embed.table.device}, engine on {self.device}"
            )
        self.cfg = cfg
        self.params = params
        self.ecfg = engine
        self.rt = (rt if rt is not None else Runtime()).replace(kv_dtype="")
        self._policy = SamplingPolicy(
            temperature=engine.temperature, vocab=cfg.vocab_size, seed=engine.seed
        )
        self.pool = PagePool(engine.num_pages, engine.page_size)
        self.scheduler = Scheduler(policy=engine.policy, max_queue=engine.max_queue)
        self.prefix: Optional[PrefixCache] = (
            PrefixCache(self.pool) if engine.prefix_cache else None
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

    # ------------------------------------------------------------- public
    def submit(
        self,
        tokens: np.ndarray,
        max_new: int,
        qos: str = "interactive",
        on_token=None,
    ) -> int:
        """Enqueue a request; returns its rid. ``on_token(rid, tokens, done)``
        gets each newly delivered token batch (``done`` None while streaming,
        then ``"complete"`` / ``"cancelled"`` once). Raises before any engine
        state changes (capacity ValueError, scheduler.QueueFull)."""
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        req = Request(
            rid=self._next_rid,
            tokens=np.asarray(tokens, np.int32).reshape(-1),
            max_new=int(max_new),
            qos=qos,
            t_submit=time.perf_counter(),
        )
        total = req.prompt_len + req.max_new - 1
        if total > self.ecfg.max_len:
            raise ValueError(
                f"request needs {total} tokens > max_len={self.ecfg.max_len}"
            )
        if self.pool.pages_for(total) > self.pool.budget:
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
        """Work pending: queued requests or seated slots."""
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

    def step(self) -> Dict[str, Any]:
        """ONE engine tick: admit -> top-up -> prefill chunk + decode steps
        -> collect -> retire. An idle engine returns ``busy=False``."""
        if not self.busy:
            return {"busy": False, "finished": [], "decoded": 0}
        if self._run_t0 is None:
            self.run_begin()
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
            if self.prefix is not None and slot.phase == "decode":
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
    def _kv_bytes_per_page(self) -> int:
        return kv_page_bytes(
            self.ecfg.page_size, self.cfg.n_kv_heads, self.cfg.head_dim,
            self.cfg.n_layers, "", torch.empty((), dtype=self.rt.dtype).element_size(),
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

    def _admission_headroom(self) -> int:
        """Free pages required beyond a newcomer's reservation under the
        optimistic policy (one tick of page crossings per running request)."""
        if self.ecfg.policy != "optimistic":
            return 0
        n_active = sum(1 for s in self._slots if s is not None)
        if n_active == 0:
            return 0
        per_slot = self.ecfg.inner_steps // self.ecfg.page_size + 1
        return (n_active + 1) * per_slot

    def _admit_free_slots(self) -> None:
        for slot_id, slot in enumerate(self._slots):
            if slot is not None:
                continue
            req = self.scheduler.peek()
            if req is None:
                break
            cached, sid = 0, None
            if self.prefix is not None:
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
                reserve = self.scheduler.reserve_tokens(req, req.prompt_len)
                shortfall = (
                    self.pool.pages_for(reserve) - cached_pages + headroom
                    - self.pool.free_pages
                )
                if shortfall > 0:
                    self.prefix.evict_until(shortfall)
            popped = self.scheduler.pop_admissible(
                self.pool, lambda r: r.prompt_len, headroom_pages=headroom,
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
        reserve = self.scheduler.reserve_tokens(req, req.prompt_len)
        self.stats["prompt_tokens"] = self.stats.get("prompt_tokens", 0) + req.prompt_len
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

    def _topup_or_evict(self) -> None:
        """Make every active slot's pages cover this tick's writes; preempt
        the youngest on exhaustion. The reserve policy reserved the whole
        horizon at admission, so it has nothing to do here."""
        if self.ecfg.policy == "reserve":
            return
        for slot_id, slot in enumerate(self._slots):
            if slot is None:
                continue
            need = int(self._len[slot_id]) + min(
                int(self._rem[slot_id]), self.ecfg.inner_steps
            )
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
            if self.prefix is not None:
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


class ReplicatedServeEngine:
    """Data-parallel serving over a mesh: a later slice."""

    def __init__(self, *args, **kwargs):
        raise _later("ReplicatedServeEngine (a mesh of replicas)",
                     "memory techniques and multi-device")
