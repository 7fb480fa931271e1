"""1-bit Adam (survey §4.3, [Tang et al. 2021]), in loopback.

Counterpart of ``repro.optim.onebit`` with ``axis_name=None``. Two phases:
a full-precision WARMUP (the variance v is still moving), then a
COMPRESSION phase where v is frozen and the momentum is sign-compressed
with error feedback — ``comp = sign(m + ef) * mean(|m + ef|)``, ``ef`` keeps
the rest. In loopback nothing is synchronized, but the compression error
still applies, as in the reference.

The compression is per JAX leaf (``init``'s ``groups``, see ``optim.base``):
a leaf of at least ``MIN_SIZE`` elements is compressed, and its scale is the
mean over the whole stacked leaf. ``m``, ``v`` and ``ef`` are kept per
tensor (lists aligned with the params), which is the reference's layout
after stacking. The phase is read on the host from the step counter, one
sync per step. The data-parallel sync (``axis_name``) raises: it is ROADMAP
queue 1 item 6.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.optim.base import Optimizer, check_groups
from repro_torch.optim.optimizers import LR, _lr_at, _zeros

MIN_SIZE = 1024


def onebit_adam(
    lr: LR = 3e-4,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    warmup_steps: int = 20,
    axis_name: Optional[str] = None,
) -> Optimizer:
    if axis_name is not None:
        raise NotImplementedError(
            f"onebit_adam over the data-parallel axis {axis_name!r} is ROADMAP "
            "queue 1 item 6, 'memory techniques and multi-device'; the port "
            "runs it in loopback (axis_name=None)"
        )

    def init(params, groups=None):
        return {"m": _zeros(params), "v": _zeros(params), "ef": _zeros(params),
                "step": torch.zeros((), dtype=torch.int32, device=params[0].device),
                "groups": check_groups(len(params), groups)}

    @torch.no_grad()
    def update(grads, state, params=None):
        step = state["step"] + 1
        in_warmup = int(step) <= warmup_steps
        stepf = step.float()
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=step.device) ** stepf
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=step.device) ** stepf
        lr_t = _lr_at(lr, state["step"])
        m, v, ef = list(state["m"]), list(state["v"]), list(state["ef"])
        for group in state["groups"]:
            for i in group:
                gf = grads[i].float()
                m[i] = b1 * m[i] + (1 - b1) * gf
                if in_warmup:
                    v[i] = b2 * v[i] + (1 - b2) * torch.square(gf)
            n = sum(m[i].numel() for i in group)
            if n >= MIN_SIZE and not in_warmup:
                # compression phase: 1-bit momentum with error feedback
                t = {i: m[i] + ef[i] for i in group}
                scale = sum(torch.sum(torch.abs(t[i])) for i in group) / n
                for i in group:
                    comp = torch.sign(t[i]) * scale
                    ef[i] = t[i] - comp
                    m[i] = comp
        updates = [-lr_t * (m[i] / bc1) / (torch.sqrt(v[i] / bc2) + eps)
                   for i in range(len(grads))]
        return updates, {"m": m, "v": v, "ef": ef, "step": step,
                         "groups": state["groups"]}

    return Optimizer(init, update)
