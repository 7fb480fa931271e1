"""Request admission/eviction policy for the continuous-batching engine.

Two QoS tiers with strict priority, FIFO within a tier, page-budget gating:
the head request is admitted into a free decode slot only when the pool can
cover its reservation —

* ``reserve`` (default): the whole horizon (prompt + max_new - 1 tokens) is
  reserved at admission, so decode-time appends can never fail; admission
  throughput trades against pool utilization.
* ``optimistic``: only the prompt is reserved; the engine tops up pages
  chunk-by-chunk and, on exhaustion, preempts the youngest running request
  (pages freed, request requeued at the front — recompute-style preemption,
  the scheduling analogue of discard-and-rematerialize).

QoS: every request carries a tier (``interactive`` or ``batch``). The
``interactive`` queue is always consulted first — a queued batch request is
admitted only when no interactive request is waiting. There is no
head-of-line bypass in either tier and no bypass *across* tiers (an
inadmissible interactive head blocks batch admission rather than letting
batch work claim the pages it is waiting for), so admission order is a
deterministic function of the submission sequence — which is what lets a
traced run reproduce per-request token streams exactly.

Backpressure: ``max_queue`` bounds each tier's wait queue; ``add`` raises
:class:`QueueFull` instead of growing past it. The async front-end
(``serve.frontend``) turns that exception into an awaitable retry, which is
how overload propagates to submitters instead of ballooning queue memory.

``ReplicaRouter`` is the layer above: data-parallel serving runs one engine
per ``data``-axis slice, and the router assigns each incoming request to the
replica with the least outstanding work (token-weighted, ties to the lowest
index so routing is deterministic). ``unroute`` rolls a routing decision
back when the chosen engine's ``submit`` raises — routing is transactional,
so a rejected request never inflates a replica's request count.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch.serve.pool import PagePool

POLICIES = ("reserve", "optimistic")
QOS_TIERS = ("interactive", "batch")


class QueueFull(RuntimeError):
    """Admission backpressure: the request's QoS tier queue is at its bound."""


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray                     # (S,) int32 prompt ids
    max_new: int
    frontend_embeds: Optional[np.ndarray] = None  # (P, d) modality prefix
    qos: str = "interactive"               # QoS tier (see QOS_TIERS)
    # Wall clock at submit() — the one TTFT origin for every serving path
    # (queued wait, prefill, and preempt-then-readmit recompute all count).
    t_submit: float = 0.0

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[0])


class Scheduler:
    def __init__(self, policy: str = "reserve", max_queue: int = 0):
        assert policy in POLICIES, policy
        self.policy = policy
        self.max_queue = max_queue          # per-tier bound; 0 = unbounded
        self._queues: Dict[str, Deque[Request]] = {
            tier: deque() for tier in QOS_TIERS
        }

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def add(self, req: Request) -> None:
        assert req.qos in QOS_TIERS, req.qos
        q = self._queues[req.qos]
        if self.max_queue and len(q) >= self.max_queue:
            raise QueueFull(
                f"{req.qos} queue at max_queue={self.max_queue}; "
                f"retry after the engine drains"
            )
        q.append(req)

    def pop(self) -> Request:
        """Unconditional priority-FIFO pop (dense fallback — no page gating)."""
        for tier in QOS_TIERS:
            if self._queues[tier]:
                return self._queues[tier].popleft()
        raise IndexError("pop from empty scheduler")

    def peek(self) -> Optional[Request]:
        """The request ``pop_admissible`` would consider next: interactive
        head if any, else batch head (prefix-cache pre-eviction looks at the
        head's match before deciding how many cache pages to free)."""
        for tier in QOS_TIERS:
            if self._queues[tier]:
                return self._queues[tier][0]
        return None

    def requeue_front(self, req: Request) -> None:
        """Preempted request goes back to the head of ITS tier (it was
        admitted first within that tier; backpressure bounds don't apply —
        the request already held a queue slot once)."""
        self._queues[req.qos].appendleft(req)

    def cancel(self, rid: int) -> Optional[Request]:
        """Remove a still-queued request; returns it, or None if not queued."""
        for q in self._queues.values():
            for r in q:
                if r.rid == rid:
                    q.remove(r)
                    return r
        return None

    def queued_tokens(self, prompt_total_of) -> int:
        """Token-weighted size of the wait queues (replica load accounting)."""
        return sum(
            prompt_total_of(r) + r.max_new
            for q in self._queues.values() for r in q
        )

    def reserve_tokens(self, req: Request, prompt_total: int) -> int:
        """Tokens to reserve at admission. The final sampled token is never
        written back (nothing consumes it), hence ``max_new - 1``."""
        if self.policy == "reserve":
            return prompt_total + max(0, req.max_new - 1)
        return prompt_total

    def pop_admissible(
        self,
        pool: PagePool,
        prompt_total_of,
        headroom_pages: int = 0,
        cached_pages_of=None,
    ) -> Optional[Request]:
        """Head request (interactive tier first) if its reservation (+ the
        engine's chunk headroom, see ``ServeEngine._admission_headroom``)
        fits the pool's free pages. ``cached_pages_of`` discounts pages the
        request will adopt from the prefix cache instead of allocating
        (shared pages are already live).

        Strict priority + strict FIFO: no bypass within or across tiers, so
        admission order (and with it per-request output, under per-slot
        sample streams) is deterministic.
        """
        req = self.peek()
        if req is None:
            return None
        need = pool.pages_for(self.reserve_tokens(req, prompt_total_of(req)))
        if cached_pages_of is not None:
            need -= cached_pages_of(req)
        if need + headroom_pages > pool.free_pages:
            return None
        popped = self._queues[req.qos].popleft()
        assert popped is req
        return popped

    def pop_batch(self, max_n: int) -> List[Request]:
        """Dense-fallback grouping: the head request plus up to ``max_n - 1``
        queued requests sharing its (prompt_len, max_new) shape (they run as
        one compiled batch). Relative order of the remaining queue entries
        is preserved."""
        head = self.pop()
        part = [head]
        key = (head.prompt_len, head.max_new)
        for tier in QOS_TIERS:
            q = self._queues[tier]
            taken = []
            for r in q:
                if len(part) >= max_n:
                    break
                if (r.prompt_len, r.max_new) == key:
                    part.append(r)
                    taken.append(r)
            for r in taken:
                q.remove(r)
        return part


class ReplicaRouter:
    """Least-loaded request routing across data-parallel engine replicas.

    The caller passes each replica's CURRENT load (token-weighted
    outstanding work — queued requests plus pool-resident sequences, see
    ``ServeEngine.outstanding_tokens``), so routing reflects what actually
    occupies KV pools and decode slots rather than a shadow counter that
    can drift from it. Ties go to the lowest index — deterministic.
    """

    def __init__(self, n_replicas: int):
        assert n_replicas >= 1
        self.routed: List[int] = [0] * n_replicas  # requests per replica

    def route(self, loads: List[int]) -> int:
        assert len(loads) == len(self.routed)
        idx = min(range(len(loads)), key=lambda i: (loads[i], i))
        self.routed[idx] += 1
        return idx

    def unroute(self, idx: int) -> None:
        """Roll back a ``route`` whose downstream submit raised — the
        transactional half of replica routing (a rejected request must not
        count against the replica it never reached)."""
        assert self.routed[idx] > 0, idx
        self.routed[idx] -= 1
