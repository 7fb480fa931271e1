"""8-bit Adam via blockwise dynamic quantization (survey §4.2, Dettmers'21).

Counterpart of ``repro.optim.lowbit``. The moments are stored as (uint8
codes, f32 per-block scales): 4x less state memory than f32 Adam. Each
update dequantizes m and v, does exact f32 Adam arithmetic, and
requantizes; on the card the codec is K8b / K8a
(``kernels.blockwise_quant``), on the CPU its plain version. The second
moment reuses the signed map, as the reference does.

Everything is per JAX leaf (``init``'s ``groups``, see ``optim.base``): a
leaf of fewer than ``MIN_SIZE`` elements keeps f32 moments, a larger one is
quantized over the row-major flat of its tensors — so the stacked norm
scales of gemma3-1b, (26, 1152), are quantized, in 256-value blocks that
straddle layers, exactly as in the reference. A slot is
``{"m": {"codes", "scales"}, "v": {...}}`` for a quantized leaf (codes of
the reference's padded length) and ``{"m", "v"}`` f32 of the leaf's size
otherwise. The arithmetic is the reference's op for op: the learning rate
read before the step increment, ``u = (m / bc1) / (sqrt(v / bc2) + eps)``,
the update ``-lr_t * u``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.kernels.blockwise_quant import dequantize, padded_size, quantize
from repro_torch.optim.base import Optimizer, check_groups, gather, scatter
from repro_torch.optim.optimizers import LR, _lr_at

MIN_SIZE = 4096


def _q(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    codes, scales, _ = quantize(x)
    return {"codes": codes, "scales": scales}


def _dq(q: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The whole padded flat, f32; the pad dequantizes to exact zeros."""
    n = q["codes"].numel()
    return dequantize(q["codes"], q["scales"], n, (n,))


def adam8bit(
    lr: LR = 3e-4,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    def init(params, groups=None):
        groups = check_groups(len(params), groups)
        dev = params[0].device
        slots = []
        for group in groups:
            n = sum(params[i].numel() for i in group)
            if n >= MIN_SIZE:
                z = torch.zeros(padded_size(n), dtype=torch.float32, device=dev)
                slots.append({"m": _q(z), "v": _q(z)})
            else:
                slots.append({"m": torch.zeros(n, dtype=torch.float32, device=dev),
                              "v": torch.zeros(n, dtype=torch.float32, device=dev)})
        return {"slots": slots, "step": torch.zeros((), dtype=torch.int32, device=dev),
                "groups": groups}

    @torch.no_grad()
    def update(grads, state, params=None):
        step = state["step"] + 1
        stepf = step.float()
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=step.device) ** stepf
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=step.device) ** stepf
        lr_t = _lr_at(lr, state["step"])

        def leaf(slot, group):
            """(new slot, flat update) of one leaf; its temporaries die here."""
            g = gather(grads, group)
            n = g.numel()
            big = n >= MIN_SIZE
            if big:  # m, v: the padded flat; the update below writes [:n] only
                m_pad, v_pad = _dq(slot["m"]), _dq(slot["v"])
                m, v = m_pad[:n], v_pad[:n]
            else:
                m, v = slot["m"], slot["v"]
            m.mul_(b1).add_((1 - b1) * g)                    # b1*m + (1-b1)*g
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            # (m / bc1) / (sqrt(v / bc2) + eps), in place where the rounding
            # is the same
            u = (m / bc1).div_(torch.sqrt(v / bc2).add_(eps))
            if weight_decay:
                u = u + weight_decay * gather(params, group)
            new = {"m": _q(m_pad), "v": _q(v_pad)} if big else {"m": m, "v": v}
            return new, u.mul_(-lr_t)                        # -lr_t * u

        updates = [None] * len(grads)
        slots = []
        for slot, group in zip(state["slots"], state["groups"]):
            new, u = leaf(slot, group)
            slots.append(new)
            for i, t in zip(group, scatter(u, grads, group)):
                updates[i] = t
        return updates, {"slots": slots, "step": step, "groups": state["groups"]}

    return Optimizer(init, update)


def state_bytes(state: Any) -> float:
    """Total bytes of the tensors in ``state`` (for the §4.2 memory
    comparison); the grouping and other non-tensors count nothing."""
    if isinstance(state, torch.Tensor):
        return float(state.numel() * state.element_size())
    if isinstance(state, dict):
        return sum(state_bytes(v) for v in state.values())
    if isinstance(state, (list, tuple)):
        return sum(state_bytes(v) for v in state)
    return 0.0
