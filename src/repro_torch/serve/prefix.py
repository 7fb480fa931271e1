"""Radix-tree prefix cache: cross-request KV reuse over the page pool.

The survey's theme — share intermediate-tensor memory instead of recomputing
it — applied to serving: thousands of requests repeat the same system prompt
and few-shot prefix, so their prompt KV is the same tensor. This module
keeps retired prompts' KV pages alive in a radix tree keyed on token IDs;
a new request walks the tree, adopts the longest cached prefix as the head
of its own pool sequence (zero prefill FLOPs for the shared part — the
pages are the literal device pages an earlier request wrote), and inserts
its own prompt pages back into the tree when it completes.

Invariants
----------
* **Page-aligned edges.** Every node's token segment is a whole number of
  pages; matching walks page-by-page, so a partially matched edge still
  yields its matched pages and siblings always differ within their first
  page (child keys = the first page's token tuple are unique).
* **Nodes own only their segment's pages**, referenced via
  ``PagePool.retain`` (one cache ref per page; ``PagePool.check`` proves
  the arithmetic). The pages covering a node's *positions 0..start-1* are
  owned by its ancestors, so eviction must be leaf-first: a node is
  evictable only when its whole subtree is idle (every page refcount == 1,
  i.e. cache-only — no live request sequence and no descendant is pinned).
* **Adoption never COWs.** Matches are truncated to a page multiple (and to
  ``prompt_len - 1`` by the engine, so at least one token remains to
  produce first-token logits), so an adopted sequence's shared tail page is
  always full and ``PagePool.append`` allocates fresh pages instead of
  copy-on-writing shared ones.
* **LRU eviction.** ``evict_until`` frees least-recently-used idle leaves
  (cascading upward as parents become leaves) back to the pool; an adopted
  page has refcount >= 2 and can never be evicted out from under a running
  request.

Correctness of reuse: KV at position p is a pure function of tokens[0..p]
(causal attention, absolute rope positions) and the parameters, so a
token-exact prefix match means the cached pages hold bit-identical KV to
what prefill would recompute.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.serve.pool import PagePool


@dataclasses.dataclass
class _Node:
    tokens: Tuple[int, ...]            # edge segment (len % page_size == 0)
    pages: List[int]                   # this segment's pages only
    parent: Optional["_Node"]
    children: Dict[Tuple[int, ...], "_Node"] = dataclasses.field(
        default_factory=dict
    )
    last_used: int = 0


class PrefixCache:
    def __init__(self, pool: PagePool):
        self.pool = pool
        self.page_size = pool.page_size
        self._root = _Node((), [], None)
        self._clock = 0
        self.lookups = 0
        self.hits = 0
        self.cached_tokens = 0      # tokens served from cache across lookups
        self.inserted_tokens = 0
        self.evicted_pages = 0

    # ------------------------------------------------------------- helpers
    def _key(self, tokens: Tuple[int, ...]) -> Tuple[int, ...]:
        return tokens[: self.page_size]

    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.last_used = self._clock

    def _edge_match_pages(self, node: _Node, tokens, off: int) -> int:
        """Whole pages of ``node.tokens`` matching ``tokens[off:]``."""
        ps = self.page_size
        m = 0
        while (m + 1) * ps <= len(node.tokens):
            seg = node.tokens[m * ps : (m + 1) * ps]
            if tuple(tokens[off + m * ps : off + (m + 1) * ps]) != seg:
                break
            m += 1
        return m

    # -------------------------------------------------------------- verbs
    def match(self, tokens, max_tokens: Optional[int] = None) -> Tuple[int, List[int]]:
        """Longest page-aligned cached prefix of ``tokens[:max_tokens]``.

        Returns ``(n_tokens, pages)`` — the caller adopts ``pages`` via
        ``PagePool.adopt``. The engine passes ``max_tokens=prompt_len - 1``
        so at least one prompt token is always left to prefill (the request
        needs last-position logits to sample its first token). Touches
        every node on the path (LRU) but does NOT count stats — the engine
        may re-match a blocked head request on every step, so
        lookups/hits/cached_tokens are counted once per ADMISSION via
        ``note_lookup`` (inflating them here would corrupt the hit-rate
        and FLOPs-saved accounting).
        """
        tokens = [int(t) for t in tokens]
        if max_tokens is not None:
            tokens = tokens[:max_tokens]
        ps = self.page_size
        node, off, pages = self._root, 0, []
        while len(tokens) - off >= ps:
            child = node.children.get(tuple(tokens[off : off + ps]))
            if child is None:
                break
            m = self._edge_match_pages(child, tokens, off)
            pages.extend(child.pages[:m])
            off += m * ps
            self._touch(child)
            if m < len(child.pages):
                break                       # partial edge: cannot descend
            node = child
        return off, pages

    def note_lookup(self, cached_tokens: int) -> None:
        """Record one admission-time lookup outcome (see ``match``)."""
        self.lookups += 1
        if cached_tokens:
            self.hits += 1
            self.cached_tokens += cached_tokens

    def insert(self, tokens, pages: List[int]) -> int:
        """Cache a retired prompt's full pages (``pages[i]`` holds positions
        ``[i*page_size, (i+1)*page_size)`` of ``tokens``). Only whole pages
        are cacheable; the trailing partial page is ignored. New nodes
        retain their pages; segments already present keep the existing
        nodes' pages (same tokens => bit-identical KV). Returns the number
        of newly cached pages."""
        tokens = [int(t) for t in tokens]
        ps = self.page_size
        n_full = min(len(tokens) // ps, len(pages))
        node, off = self._root, 0
        while off < n_full * ps:
            key = tuple(tokens[off : off + ps])
            child = node.children.get(key)
            if child is None:
                seg = tuple(tokens[off : n_full * ps])
                new_pages = list(pages[off // ps : n_full])
                self.pool.retain(new_pages)
                fresh = _Node(seg, new_pages, node)
                node.children[key] = fresh
                self._touch(fresh)
                self.inserted_tokens += len(seg)
                return len(new_pages)
            m = self._edge_match_pages(child, tokens, off)
            avail = (n_full * ps - off) // ps
            m = min(m, avail)
            if m < len(child.pages):
                if m == avail:
                    # our prompt ends inside (or exactly at a page boundary
                    # of) this edge — fully covered, nothing new to cache
                    self._touch(child)
                    return 0
                # diverges mid-edge: split the child at the match point so
                # the shared pages get their own node
                self._split(node, child, m)
                child = node.children[key]
            off += m * ps
            self._touch(child)
            node = child
        return 0

    def _split(self, parent: _Node, child: _Node, m: int) -> None:
        """Split ``child`` after its first ``m`` pages (0 < m < len)."""
        ps = self.page_size
        assert 0 < m < len(child.pages)
        top = _Node(
            child.tokens[: m * ps], child.pages[:m], parent,
            last_used=child.last_used,
        )
        child.tokens = child.tokens[m * ps :]
        child.pages = child.pages[m:]
        child.parent = top
        top.children[self._key(child.tokens)] = child
        parent.children[self._key(top.tokens)] = top

    # ----------------------------------------------------------- eviction
    def _idle(self, node: _Node) -> bool:
        """No live sequence references any page of this subtree."""
        return all(self.pool.refcount(p) == 1 for p in node.pages) and all(
            self._idle(c) for c in node.children.values()
        )

    def evictable_pages(self) -> int:
        """Pages ``evict_until`` could return to the pool right now: every
        node whose whole subtree is idle frees by leaf-first cascade. A
        busy node's idle descendants still count (their own pages free);
        the busy node itself and its ancestors do not."""
        total = 0
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if self._idle(n):
                total += len(n.pages) + sum(
                    len(d.pages) for d in self._descendants(n)
                )
            else:
                stack.extend(n.children.values())
        return total

    def _descendants(self, node: _Node):
        out = []
        stack = list(node.children.values())
        while stack:
            n = stack.pop()
            out.append(n)
            stack.extend(n.children.values())
        return out

    def _evictable_leaves(self) -> List[_Node]:
        leaves = []
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif all(self.pool.refcount(p) == 1 for p in n.pages):
                leaves.append(n)
        return leaves

    def evict_until(self, n_pages: int) -> int:
        """Free at least ``n_pages`` pages (LRU idle leaves first, cascading
        into parents as they become childless). Returns pages freed — may
        be less than asked when everything left is pinned by live
        sequences. One tree scan seeds the victim heap; cascades are local
        (evicting a leaf can only newly expose its own parent), so the cost
        is O(tree + victims log victims), not a rescan per victim."""
        import heapq

        heap = [
            (n.last_used, id(n), n) for n in self._evictable_leaves()
        ]
        heapq.heapify(heap)
        freed = 0
        while freed < n_pages and heap:
            _, _, node = heapq.heappop(heap)
            parent = node.parent
            freed += self._evict(node)
            if (
                parent is not self._root
                and not parent.children
                and all(self.pool.refcount(p) == 1 for p in parent.pages)
            ):
                heapq.heappush(heap, (parent.last_used, id(parent), parent))
        return freed

    def _evict(self, node: _Node) -> int:
        assert not node.children
        self.pool.release(node.pages)
        n = len(node.pages)
        self.evicted_pages += n
        parent = node.parent
        parent.children.pop(self._key(node.tokens))
        return n

    def clear(self) -> int:
        """Evict everything evictable (pinned nodes stay). Returns pages
        freed."""
        return self.evict_until(self.pages_cached())

    # ------------------------------------------------------------ inspect
    def pages_cached(self) -> int:
        return sum(len(n.pages) for n in self._descendants(self._root))

    def tokens_cached(self) -> int:
        return self.pages_cached() * self.page_size

    def stats(self) -> Dict[str, float]:
        return {
            "prefix_lookups": self.lookups,
            "prefix_hits": self.hits,
            "prefix_cached_tokens": self.cached_tokens,
            "prefix_pages_cached": self.pages_cached(),
            "prefix_evicted_pages": self.evicted_pages,
        }

    def check(self) -> None:
        """Structural invariants (exercised by the property tests)."""
        seen: set = set()
        stack = [(self._root, True)]
        while stack:
            node, is_root = stack.pop()
            if not is_root:
                assert node.tokens and len(node.tokens) % self.page_size == 0
                assert len(node.pages) * self.page_size == len(node.tokens)
                for p in node.pages:
                    assert p not in seen, f"page {p} in two nodes"
                    seen.add(p)
                    assert self.pool.refcount(p) >= 1
            for key, child in node.children.items():
                assert key == self._key(child.tokens)
                assert child.parent is node
                stack.append((child, False))
