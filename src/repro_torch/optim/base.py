"""Composable optimizer API over the parameter list (counterpart of
``repro.optim.base``).

An Optimizer is (init, update), as in the JAX package:
    state          = opt.init(params)
    updates, state = opt.update(grads, state, params)
    apply_updates(params, updates)

``params`` is a list of tensors (``list(LM.parameters())``); per-parameter
state entries are lists aligned with it, so ``checkpoint.convert`` carries
them to and from the JAX trees.

``init(params, groups=None)`` also takes the JAX leaves: ``groups`` lists,
for each leaf of the JAX parameter tree, the indices of the tensors that
form it, in layer order (``checkpoint.convert.leaf_groups``). The JAX stack
keeps each per-layer weight as one stacked ``(L, ...)`` leaf, and an
optimizer whose arithmetic is not elementwise works per leaf: the low-bit
optimizers' size threshold, quantization blocks and scales, and 1-bit
Adam's compression scale. Such an optimizer sees a leaf as the row-major
flat of its tensors, layer 0's elements first. Without ``groups`` each
tensor is its own leaf, which is right for a plain list of tensors. The
state keeps the grouping under ``"groups"``.

``update`` may change the state's tensors in place: the training step calls
it only on finite grads (the JAX step's ``where(finite, new, old)``), so
nothing needs the old values afterwards.
``torch.optim.AdamW`` and ``clip_grad_norm_`` are not used: they read the
learning rate after the step increment and clip with 1e-6 in the
denominator, where the reference reads it before and uses 1e-9.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

Groups = Tuple[Tuple[int, ...], ...]


class Optimizer(NamedTuple):
    init: Callable[..., Any]                     # (params, groups=None) -> state
    update: Callable[..., Tuple[List[torch.Tensor], Any]]


@torch.no_grad()
def apply_updates(params: List[torch.Tensor], updates: List[torch.Tensor]) -> None:
    """params += updates, in place (JAX: ``(p + u).astype(p.dtype)``)."""
    for p, u in zip(params, updates):
        p.copy_((p + u).to(p.dtype))


def check_groups(n: int, groups: Optional[Sequence[Sequence[int]]] = None) -> Groups:
    """``groups`` checked to cover the ``n`` tensors once each; each tensor
    alone when ``groups`` is None."""
    if groups is None:
        return tuple((i,) for i in range(n))
    out = tuple(tuple(int(i) for i in g) for g in groups)
    if sorted(i for g in out for i in g) != list(range(n)) or not all(out):
        raise ValueError(f"groups {out} do not cover {n} tensors once each")
    return out


def gather(tensors: List[torch.Tensor], group: Sequence[int]) -> torch.Tensor:
    """The f32 flat of one leaf: its tensors' elements in order (a view when
    the leaf is one contiguous f32 tensor)."""
    if len(group) == 1:
        return tensors[group[0]].reshape(-1).float()
    return torch.cat([tensors[i].reshape(-1).float() for i in group])


def scatter(flat: torch.Tensor, params: List[torch.Tensor],
            group: Sequence[int]) -> List[torch.Tensor]:
    """Views of ``flat`` shaped like the leaf's tensors, in order."""
    sizes = [params[i].numel() for i in group]
    return [t.view(params[i].shape) for t, i in zip(flat.split(sizes), group)]


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    total = sum(torch.sum(torch.square(g.float())) for g in tensors)
    return torch.sqrt(total)


def clip_by_global_norm(
    grads: List[torch.Tensor], max_norm: float
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return [g * scale for g in grads], norm


# ------------------------------------------------------------------ schedules
@dataclasses.dataclass(frozen=True)
class Schedule:
    """Warmup + {constant, cosine, linear} decay, with the linear-scaling rule
    [Goyal et al. 2017]: lr = base_lr * (global_batch / base_batch)."""

    base_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    kind: str = "cosine"             # cosine | linear | constant
    base_batch: int = 0              # 0 = linear-scaling rule off
    global_batch: int = 0
    min_ratio: float = 0.1

    def __call__(self, step: torch.Tensor) -> torch.Tensor:
        lr = self.base_lr
        if self.base_batch and self.global_batch:
            lr = lr * self.global_batch / self.base_batch
        step = torch.as_tensor(step).float()
        warm = torch.clamp((step + 1) / max(self.warmup_steps, 1), max=1.0)
        frac = torch.clamp(
            (step - self.warmup_steps) / max(self.total_steps - self.warmup_steps, 1),
            0.0, 1.0,
        )
        if self.kind == "cosine":
            decay = self.min_ratio + (1 - self.min_ratio) * 0.5 * (
                1 + torch.cos(math.pi * frac)
            )
        elif self.kind == "linear":
            decay = 1.0 - (1 - self.min_ratio) * frac
        else:
            decay = torch.ones_like(frac)
        return lr * warm * decay
