"""Mixture-of-Experts FFN with sort-based capacity dispatch.

Counterpart of ``repro.models.moe`` in its local mode (all experts on one
device). The router picks ``top_k`` experts a token; each expert takes at
most ``C = ceil(cf * T * k / E)`` of the routed (token, choice) slots, the
earliest by token order, and the rest are dropped (their contribution is
0). The arithmetic is the JAX package's, step by step:

* router logits in the compute dtype, then f32; softmax; top-k;
  renormalisation of the k weights;
* the Switch/GShard load-balance aux loss over the full router view;
* a stable sort of the slots by expert, group starts by ``searchsorted``
  (side left), ``pos < C`` keeps the earliest slots;
* the kept slots gathered into an (E, C, d) buffer with zero rows for empty
  places, the expert MLPs as three batched products (``torch.bmm``: JAX
  computes these einsums outside any Pallas kernel) and ``silu`` as XLA
  computes ``jax.nn.silu``, each row scaled by its gate weight in the compute
  dtype;
* the combine: each token adds its k buffer rows in the order of their
  expert ids, rounding to the compute dtype after each add, as JAX's
  scatter-add walks the expert-sorted buffer.

Two choices keep the card bitwise repeatable and on JAX's picks. Top-k is a
stable descending sort, so among equal probabilities the lower expert id
comes first, as ``jax.lax.top_k`` promises (``torch.topk`` on CUDA promises
no order among ties, and bf16 router logits over 128 experts tie often).
The combine gathers and adds in a fixed order instead of an atomic
``index_add_``. Every scatter here writes one value to each place, or the
same value to a shared trash place.

Capacity counts every routed row, so a row's output depends on the other
rows of the call: padding and inactive rows included. Decode reads every
expert's weights, as JAX's dense (E, C, d) buffer does, whichever hold a
token. The expert-parallel mode (``axis_name``) is ROADMAP queue 1 item 6.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.models.layers import dense_init, frozen, silu


class MoE(nn.Module):
    """The router (d, E) and the experts stacked on a leading E axis:
    ``w_up``/``w_gate`` (E, d, f) and ``w_down`` (E, f, d), as in the JAX
    tree."""

    def __init__(self, router, w_up, w_down, w_gate=None):
        super().__init__()
        self.router = frozen(router)
        self.w_up = frozen(w_up)
        self.w_down = frozen(w_down)
        self.w_gate = None if w_gate is None else frozen(w_gate)


def init_moe(gen: torch.Generator, d: int, d_ff: int, n_experts: int, gated: bool,
             dtype) -> MoE:
    """Fan-in truncated-normal router and experts on ``gen``'s device,
    stored at ``dtype``: the distributions of ``repro.models.moe.init_moe``.
    Each stack is drawn in f32 and cast at once, one leaf at a time, so the
    model is never held in f32."""
    def stack(d_in: int, d_out: int) -> torch.Tensor:
        return dense_init(gen, d_in, d_out, dtype=dtype, lead=n_experts)

    return MoE(
        dense_init(gen, d, n_experts, dtype=dtype),
        stack(d, d_ff),
        stack(d_ff, d),
        stack(d, d_ff) if gated else None,
    )


def capacity(n_tokens: int, top_k: int, n_experts: int, cf: float) -> int:
    return max(1, math.ceil(cf * n_tokens * top_k / n_experts))


class Routing(NamedTuple):
    """One call's routing. Slots are the (token, choice) pairs in token-major
    order; ``order`` sorts them by expert (stable)."""
    probs: torch.Tensor       # (T, E) f32 router softmax
    gate_w: torch.Tensor      # (T, k) f32 renormalised weights
    gate_idx: torch.Tensor    # (T, k) expert ids, best first
    order: torch.Tensor       # (T*k,) slot ids sorted by expert
    keep: torch.Tensor        # (T*k,) bool, in sorted order: within capacity
    dest: torch.Tensor        # (T*k,) buffer row e*C + pos, in sorted order
    capacity: int
    aux: torch.Tensor         # () f32 load-balance loss

    def kept_pairs(self) -> torch.Tensor:
        """(n_kept, 2) (token, expert) pairs that reach an expert, sorted."""
        k = self.gate_idx.shape[1]
        tok = torch.div(self.order, k, rounding_mode="floor")
        e = self.gate_idx.reshape(-1)[self.order]
        pairs = torch.stack([tok[self.keep], e[self.keep]], dim=1)
        return pairs[torch.argsort(pairs[:, 0] * self.probs.shape[1] + pairs[:, 1])]


def route(p: MoE, xt: torch.Tensor, *, top_k: int, capacity_factor: float) -> Routing:
    """Router, top-k, aux loss and slot bookkeeping for xt (T, d)."""
    T = xt.shape[0]
    E = p.w_up.shape[0]
    logits = (xt @ p.router.to(xt.dtype)).float()                   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # stable: among equal probabilities the lower expert id first (lax.top_k)
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_idx = srt[:, :top_k], idx[:, :top_k]
    gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True)

    n_slots = T * top_k
    slot_expert = gate_idx.reshape(n_slots)
    frac_routed = torch.bincount(slot_expert, minlength=E).float() / n_slots
    aux = E * torch.sum(frac_routed * probs.mean(dim=0))

    order = torch.argsort(slot_expert, stable=True)
    le_s = slot_expert[order]
    arange = torch.arange(n_slots, device=xt.device)
    group_start = torch.searchsorted(le_s, torch.arange(E + 1, device=xt.device))
    pos = arange - group_start[le_s]
    C = capacity(T, top_k, E, capacity_factor)
    keep = pos < C
    return Routing(probs, gate_w, gate_idx, order, keep, le_s * C + pos, C, aux)


def moe_apply(
    p: MoE,
    x: torch.Tensor,
    *,
    top_k: int,
    capacity_factor: float,
    gated: bool,
    axis_name: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss f32 scalar)."""
    if axis_name is not None:
        raise NotImplementedError(
            "expert-parallel MoE (axis_name) is not in the PyTorch port yet "
            "(ROADMAP.md queue 1: item 6, memory techniques and multi-device)"
        )
    B, S, d = x.shape
    dtype = x.dtype
    T = B * S
    xt = x.reshape(T, d)
    E = p.w_up.shape[0]
    r = route(p, xt, top_k=top_k, capacity_factor=capacity_factor)
    C = r.capacity
    n_slots = T * top_k

    # buffer row -> token and gate weight; dropped slots write the trash row
    trash = E * C
    dest = torch.where(r.keep, r.dest, trash)
    tok_s = torch.div(r.order, top_k, rounding_mode="floor")
    tok_for_row = torch.full((trash + 1,), -1, dtype=torch.long, device=x.device)
    tok_for_row[dest] = torch.where(r.keep, tok_s, -1)
    w_for_row = torch.zeros(trash + 1, dtype=torch.float32, device=x.device)
    w_for_row[dest] = torch.where(r.keep, r.gate_w.reshape(n_slots)[r.order], 0.0)
    tok_for_row, w_for_row = tok_for_row[:-1], w_for_row[:-1]

    valid = tok_for_row >= 0
    xin = torch.where(valid[:, None], xt[tok_for_row.clamp(min=0)], 0).reshape(E, C, d)
    up = torch.bmm(xin, p.w_up.to(dtype))
    if gated:
        h = silu(torch.bmm(xin, p.w_gate.to(dtype))) * up
    else:
        h = silu(up)
    y = torch.bmm(h, p.w_down.to(dtype)).reshape(trash, d) * w_for_row[:, None].to(dtype)

    # combine: each token's k buffer rows (the trash row, zeros, where
    # dropped), added in expert order with a rounding after each add
    row_of_slot = torch.empty(n_slots, dtype=torch.long, device=x.device)
    row_of_slot[r.order] = dest
    by_expert = torch.argsort(r.gate_idx, dim=1)
    rows = torch.gather(row_of_slot.reshape(T, top_k), 1, by_expert)
    parts = torch.cat([y, y.new_zeros(1, d)])[rows]                 # (T, k, d)
    out = parts[:, 0]
    for j in range(1, top_k):
        out = out + parts[:, j]
    return out.reshape(B, S, d), r.aux
