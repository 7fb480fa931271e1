"""Mixed-precision policy + dynamic loss scaling (counterpart of
``repro.core.precision``).

Master params stay f32; compute runs in a lower dtype. bf16 needs no loss
scaling; the fp16 path keeps the standard dynamic scale: double every
``growth_interval`` clean steps, halve on non-finite grads and skip the
update. The scale state is two device scalars, so the step never waits on
the host for it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    compute_dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    use_loss_scaling: bool = False
    init_scale: float = 2.0**15
    growth_interval: int = 2000

    @staticmethod
    def bf16() -> "PrecisionPolicy":
        return PrecisionPolicy()

    @staticmethod
    def f32() -> "PrecisionPolicy":
        return PrecisionPolicy(compute_dtype=torch.float32)

    @staticmethod
    def fp16() -> "PrecisionPolicy":
        return PrecisionPolicy(compute_dtype=torch.float16, use_loss_scaling=True)


def init_scale_state(policy: PrecisionPolicy, *, device) -> Dict[str, torch.Tensor]:
    return {
        "scale": torch.tensor(policy.init_scale if policy.use_loss_scaling else 1.0,
                              dtype=torch.float32, device=device),
        "good_steps": torch.tensor(0, dtype=torch.int32, device=device),
    }


def scale_loss(loss: torch.Tensor, state: Dict[str, torch.Tensor]) -> torch.Tensor:
    return loss * state["scale"]


def unscale_and_check(
    grads: List[torch.Tensor], state: Dict[str, torch.Tensor], policy: PrecisionPolicy
) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor], torch.Tensor]:
    """Unscale grads; detect non-finite; update the dynamic scale.

    Returns (grads f32, new_state, grads_finite as a device bool). Callers
    skip the optimizer update when grads_finite is False."""
    inv = 1.0 / state["scale"]
    grads = [g.float() * inv for g in grads]
    finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
    if not policy.use_loss_scaling:
        return grads, state, finite
    good = torch.where(finite, state["good_steps"] + 1, 0).to(torch.int32)
    grow = good >= policy.growth_interval
    new_scale = torch.where(
        finite,
        torch.where(grow, state["scale"] * 2.0, state["scale"]),
        torch.clamp(state["scale"] * 0.5, min=1.0),
    )
    return grads, {"scale": new_scale,
                   "good_steps": torch.where(grow, 0, good).to(torch.int32)}, finite
