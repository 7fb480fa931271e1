"""Host-side KV page-pool allocator for the paged serve engine.

The device side is a set of per-layer ``(num_pages, page_size, Kv, hd)``
pools plus per-request block tables (``repro.models.stack.init_stack_pool``);
this module owns the metadata: which pages belong to which sequence, page
refcounts for prefix sharing, and the free list. It is the inference-side
analogue of vDNN-style memory virtualization — KV tensors are addressed
through a translation table instead of living at a dense (B, S) extent.

Semantics
---------
* Page 0 is reserved as the null page (block-table padding and inactive-slot
  writes land there); the usable budget is ``num_pages - 1``.
* ``alloc``/``append`` reserve *capacity* in tokens; ``append`` grows a
  sequence page-by-page and raises :class:`PoolExhausted` (never
  overcommits) when the budget is gone.
* ``fork`` shares all of a sequence's pages (refcount++) — the shared-prompt
  -prefix path. A forked sequence that appends into a shared, partially
  filled tail page triggers copy-on-write: a fresh page is allocated and a
  (src, dst) device copy is queued (``drain_copies``). Full shared pages are
  immutable (appends never rewrite positions below the sequence length), so
  they stay shared for free.
* The radix prefix cache (``serve.prefix``) holds pages *outside* any
  sequence via ``retain``/``release`` (tracked separately so ``check`` can
  still prove every refcount), and turns a matched page run back into a
  request-owned sequence with ``adopt`` — fork generalized to an arbitrary
  page list.
* Quantized pools (``EngineConfig.kv_dtype`` int8/fp8) change nothing here:
  scale buffers are extra leaves of the same device pool tree, indexed by
  the same page ids, so freeing a page frees its scales, COW copies move
  codes + scales together, and adoption stays zero-FLOP (the bytes were
  quantized once at write time). ``kv_page_bytes`` is the one byte-pricing
  rule for both layouts.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


class PoolExhausted(RuntimeError):
    """Raised when an alloc/append cannot be served from the free list."""


def kv_page_bytes(
    page_size: int, n_kv: int, head_dim: int, n_layers: int,
    kv_dtype: str = "", native_itemsize: int = 2,
) -> int:
    """Device bytes one pool page costs across all layers (K + V codes, plus
    the per-(slot, head) f32 scale buffers under a quantized ``kv_dtype``).
    The single byte-accounting rule shared by the engine's per-request
    stats, ``EngineConfig.capacity``, the serve CLI, and the
    quantized-pool bench — page metadata here is host-side and free."""
    from repro_torch.kernels.paged_attention.quant import kv_token_bytes

    return page_size * n_layers * kv_token_bytes(
        n_kv, head_dim, kv_dtype, native_itemsize
    )


@dataclasses.dataclass
class _Seq:
    pages: List[int]
    tokens: int          # reserved capacity in tokens


class PagePool:
    def __init__(self, num_pages: int, page_size: int):
        assert num_pages >= 2 and page_size >= 1
        self.num_pages = num_pages
        self.page_size = page_size
        # pop() hands out ascending page ids; page 0 reserved (null page)
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._ref: Dict[int, int] = {}
        self._seqs: Dict[int, _Seq] = {}
        self._cache_refs: Dict[int, int] = {}   # prefix-cache retains
        self._next_id = 0
        self.high_water = 0
        self._pending_copies: List[Tuple[int, int]] = []

    # ------------------------------------------------------------- inspect
    @property
    def budget(self) -> int:
        return self.num_pages - 1

    @property
    def pages_in_use(self) -> int:
        return self.budget - len(self._free)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def tokens_in_use(self) -> int:
        """Total reserved token capacity across live sequences (the load
        measure the replica router balances on)."""
        return sum(s.tokens for s in self._seqs.values())

    def seq_pages(self, sid: int) -> List[int]:
        return list(self._seqs[sid].pages)

    def seq_tokens(self, sid: int) -> int:
        return self._seqs[sid].tokens

    def pages_for(self, n_tokens: int) -> int:
        return max(1, -(-n_tokens // self.page_size))

    def refcount(self, page: int) -> int:
        """Live references (sequence memberships + cache retains) on a page."""
        return self._ref.get(page, 0)

    # -------------------------------------------------------------- verbs
    def _take(self) -> int:
        if not self._free:
            raise PoolExhausted(
                f"pool exhausted: {self.pages_in_use}/{self.budget} pages in use"
            )
        page = self._free.pop()
        self._ref[page] = 1
        self.high_water = max(self.high_water, self.pages_in_use)
        return page

    def _release(self, page: int) -> None:
        self._ref[page] -= 1
        if self._ref[page] == 0:
            del self._ref[page]
            self._free.append(page)
            # a pending COW copy into a now-dead page has no beneficiary;
            # drop it so a future owner of the page cannot be clobbered.
            # (Copies FROM a released page stay: the device data is intact
            # until the page is reallocated AND rewritten, and the engine
            # drains copies at every allocation point before any write.)
            self._pending_copies = [
                c for c in self._pending_copies if c[1] != page
            ]

    def alloc(self, n_tokens: int) -> int:
        """Reserve capacity for ``n_tokens`` in a fresh sequence; returns its
        id. All-or-nothing: on exhaustion nothing is leaked."""
        n_pages = self.pages_for(n_tokens)
        if n_pages > len(self._free):
            raise PoolExhausted(
                f"need {n_pages} pages, {len(self._free)} free"
            )
        sid = self._next_id
        self._next_id += 1
        self._seqs[sid] = _Seq([self._take() for _ in range(n_pages)],
                               max(1, n_tokens))
        return sid

    def append(self, sid: int, n_tokens: int = 1) -> None:
        """Grow a sequence's reserved capacity by ``n_tokens``, allocating
        pages on boundary crossings (copy-on-write first if the tail page is
        shared and partially filled)."""
        seq = self._seqs[sid]
        if n_tokens <= 0:
            return
        new_tokens = seq.tokens + n_tokens
        tail = seq.pages[-1]
        if self._ref[tail] > 1 and seq.tokens % self.page_size != 0:
            fresh = self._take()          # copy-on-write of the shared tail
            self._pending_copies.append((tail, fresh))
            self._release(tail)
            seq.pages[-1] = fresh
        need = self.pages_for(new_tokens) - len(seq.pages)
        if need > len(self._free):
            raise PoolExhausted(
                f"need {need} pages, {len(self._free)} free"
            )
        seq.pages.extend(self._take() for _ in range(need))
        seq.tokens = new_tokens

    def ensure(self, sid: int, n_tokens: int) -> None:
        """Grow reserved capacity to at least ``n_tokens`` (idempotent)."""
        self.append(sid, n_tokens - self._seqs[sid].tokens)

    def truncate(self, sid: int, n_tokens: int) -> None:
        """Shrink a sequence's reserved capacity to ``n_tokens`` (floor 1,
        matching ``alloc``), releasing tail pages past
        ``pages_for(n_tokens)`` — the rejection-rollback verb of speculative
        decoding. Refcount/COW-safe by construction: a released tail page
        only drops one reference (a fork or prefix-cache retain keeps the
        device bytes alive for its other owners), ``_release`` already drops
        pending COW copies whose destination page dies with the truncation,
        and no data moves — positions below ``n_tokens`` are untouched,
        while stale tokens above are unreachable under the engine's
        write-then-attend contract (never attended past the committed
        length, overwritten before any future attend). Growing is not this
        verb's job: ``n_tokens >= tokens`` is a no-op."""
        seq = self._seqs[sid]
        n_tokens = max(1, n_tokens)
        if n_tokens >= seq.tokens:
            return
        keep = self.pages_for(n_tokens)
        while len(seq.pages) > keep:
            self._release(seq.pages.pop())
        seq.tokens = n_tokens

    def retain(self, pages: List[int]) -> None:
        """Cache-side reference on already-live pages (no sequence). The
        prefix cache retains a retiring request's prompt pages so they
        survive ``free``; ``release`` is the eviction-side inverse."""
        for p in pages:
            assert p in self._ref, f"retain of dead page {p}"
            self._ref[p] += 1
            self._cache_refs[p] = self._cache_refs.get(p, 0) + 1

    def release(self, pages: List[int]) -> None:
        """Drop cache-side references (pages return to the free list at 0)."""
        for p in pages:
            assert self._cache_refs.get(p, 0) > 0, f"release of unretained {p}"
            self._cache_refs[p] -= 1
            if self._cache_refs[p] == 0:
                del self._cache_refs[p]
            self._release(p)

    def adopt(self, pages: List[int], n_tokens: int) -> int:
        """New sequence referencing an existing page run (refcount++ each) —
        ``fork`` generalized to an arbitrary page list. The prefix-cache
        adoption path: a request's matched prefix pages become the head of
        its own sequence, then ``append``/``ensure`` grow the tail. The
        caller guarantees ``pages`` covers ``n_tokens`` (page-aligned match,
        so the shared tail page is always full and appends never COW it)."""
        assert pages, "adopt of empty page run (use alloc)"
        assert len(pages) == self.pages_for(n_tokens), (pages, n_tokens)
        for p in pages:
            assert p in self._ref, f"adopt of dead page {p}"
            self._ref[p] += 1
        sid = self._next_id
        self._next_id += 1
        self._seqs[sid] = _Seq(list(pages), max(1, n_tokens))
        return sid

    def fork(self, sid: int) -> int:
        """New sequence sharing every page of ``sid`` (prompt-prefix reuse)."""
        src = self._seqs[sid]
        for p in src.pages:
            self._ref[p] += 1
        new_sid = self._next_id
        self._next_id += 1
        self._seqs[new_sid] = _Seq(list(src.pages), src.tokens)
        return new_sid

    def free(self, sid: int) -> None:
        seq = self._seqs.pop(sid)
        for p in seq.pages:
            self._release(p)

    def drain_copies(self) -> List[Tuple[int, int]]:
        """Pending (src, dst) device page copies queued by copy-on-write."""
        out, self._pending_copies = self._pending_copies, []
        return out

    def table(self, sid: int, width: int) -> List[int]:
        """Block-table row, padded with 0 (the null page)."""
        pages = self._seqs[sid].pages
        assert len(pages) <= width, (len(pages), width)
        return pages + [0] * (width - len(pages))

    # ---------------------------------------------------------- invariants
    def check(self) -> None:
        """Internal consistency (exercised by the property tests)."""
        held: Dict[int, int] = {}
        for seq in self._seqs.values():
            assert len(seq.pages) == len(set(seq.pages)), "dup page in seq"
            for p in seq.pages:
                held[p] = held.get(p, 0) + 1
        for p, n in self._cache_refs.items():
            assert n > 0, (p, n)
            held[p] = held.get(p, 0) + n
        assert held == self._ref, (held, self._ref)
        assert not (set(held) & set(self._free)), "page both held and free"
        assert 0 not in held, "null page handed out"
        assert len(held) + len(self._free) == self.budget, "page leaked"
        assert self.high_water <= self.budget
