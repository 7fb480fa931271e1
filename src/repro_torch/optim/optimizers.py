"""SGD / Adam(W) / LARS / LAMB over the parameter list (counterpart of
``repro.optim.optimizers``).

The arithmetic is the JAX package's, op for op in f32: AdamW reads the
learning rate at the pre-increment step, and bias corrections are
``1 - b ** step`` in f32. LARS and LAMB apply the per-layer trust ratio
``||w|| / ||update||`` (1 when either norm is 0), with the norms taken over
each JAX leaf (``init``'s ``groups``): for the stacked ``(L, ...)`` leaves,
over all L layers, as the reference takes them. The low-bit and 1-bit
optimizers live in ``lowbit``, ``lowbit4`` and ``onebit``; ``get`` names
them all.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Union

import torch

from repro_torch.optim.base import Optimizer, check_groups

LR = Union[float, Callable]


def _lr_at(lr: LR, step: torch.Tensor) -> torch.Tensor:
    return lr(step) if callable(lr) else torch.tensor(lr, dtype=torch.float32,
                                                      device=step.device)


def _norm(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The 2-norm of one leaf, given as its tensors."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in xs))


def _trust_ratio(p: Sequence[torch.Tensor], u: Sequence[torch.Tensor],
                 eps: float = 1e-9) -> torch.Tensor:
    pn, un = _norm(p), _norm(u)
    return torch.where((pn > 0) & (un > 0), pn / (un + eps), 1.0)


def _zeros(params: List[torch.Tensor]) -> List[torch.Tensor]:
    return [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]


def _step0(params: List[torch.Tensor]) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=params[0].device)


def sgd(lr: LR = 1e-2, momentum: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params, groups=None):
        return {"mu": _zeros(params), "step": _step0(params),
                "groups": check_groups(len(params), groups)}

    def update(grads, state, params=None):
        step = state["step"]
        mu = [momentum * m + g.float() for m, g in zip(state["mu"], grads)]
        upd = [momentum * m + g.float() for m, g in zip(mu, grads)] if nesterov else mu
        lr_t = _lr_at(lr, step)
        return [-lr_t * u for u in upd], {"mu": mu, "step": step + 1,
                                          "groups": state["groups"]}

    return Optimizer(init, update)


def adamw(
    lr: LR = 3e-4,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    def init(params, groups=None):
        return {"m": _zeros(params), "v": _zeros(params), "step": _step0(params),
                "groups": check_groups(len(params), groups)}

    @torch.no_grad()
    def update(grads, state, params=None):
        step = state["step"] + 1
        stepf = step.float()
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=step.device) ** stepf
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=step.device) ** stepf
        lr_t = _lr_at(lr, state["step"])
        updates = []
        for i, g in enumerate(grads):
            g = g.float()
            m = state["m"][i].mul_(b1).add_((1 - b1) * g)      # b1*m + (1-b1)*g
            v = state["v"][i].mul_(b2).add_((1 - b2) * torch.square(g))
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay and params is not None:
                u = u + weight_decay * params[i].float()
            updates.append(-lr_t * u)
        return updates, {"m": state["m"], "v": state["v"], "step": step,
                         "groups": state["groups"]}

    return Optimizer(init, update)


def lars(
    lr: LR = 1e-2,
    momentum: float = 0.9,
    weight_decay: float = 1e-4,
    trust_coef: float = 1e-3,
) -> Optimizer:
    """Layer-wise Adaptive Rate Scaling over SGD-momentum."""
    def init(params, groups=None):
        return {"mu": _zeros(params), "step": _step0(params),
                "groups": check_groups(len(params), groups)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"]
        lr_t = _lr_at(lr, step)
        mu: List[torch.Tensor] = [None] * len(params)
        updates: List[torch.Tensor] = [None] * len(params)
        for group in state["groups"]:
            g = [grads[i].float() + weight_decay * params[i].float() for i in group]
            local = trust_coef * _trust_ratio([params[i] for i in group], g)
            for i, gi in zip(group, g):
                mu[i] = momentum * state["mu"][i] + local * gi
                updates[i] = -lr_t * mu[i]
        return updates, {"mu": mu, "step": step + 1, "groups": state["groups"]}

    return Optimizer(init, update)


def lamb(
    lr: LR = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-6,
    weight_decay: float = 0.01,
) -> Optimizer:
    """LAMB: the AdamW direction rescaled by the per-layer trust ratio."""
    inner = adamw(1.0, b1, b2, eps, 0.0)  # unit-lr Adam direction

    def update(grads, state, params):
        lr_t = _lr_at(lr, state["step"])
        dirs, new_state = inner.update(grads, state, params)
        updates: List[torch.Tensor] = [None] * len(params)
        for group in state["groups"]:
            r = [-dirs[i] for i in group]  # inner returned -1.0 * direction
            if weight_decay:
                r = [ri + weight_decay * params[i].float() for ri, i in zip(r, group)]
            ratio = _trust_ratio([params[i] for i in group], r)
            for i, ri in zip(group, r):
                updates[i] = -lr_t * ratio * ri
        return updates, new_state

    return Optimizer(inner.init, update)


def get(name: str, lr: LR, **kw) -> Optimizer:
    table = {"sgd": sgd, "adamw": adamw, "adam": adamw, "lars": lars, "lamb": lamb}
    if name == "adam8bit":
        from repro_torch.optim.lowbit import adam8bit

        return adam8bit(lr, **kw)
    if name == "adam4bit":
        from repro_torch.optim.lowbit4 import adam4bit

        return adam4bit(lr, **kw)
    if name == "onebit_adam":
        from repro_torch.optim.onebit import onebit_adam

        return onebit_adam(lr, **kw)
    return table[name](lr, **kw)
