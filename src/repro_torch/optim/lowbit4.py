"""4-bit optimizer states with adaptive Gradient Scaling (survey §4.2,
[Sun et al. 2020] "Ultra-Low Precision 4-bit Training").

Counterpart of ``repro.optim.lowbit4``, op for op. The 4-bit map is the
signed dynamic construction with 3 exponent levels (7 positive codes +
mirror + {0, 1.0} = 16). The first moment is stored in 4 bits over
256-value blocks (``quantize4``, plain torch as in the reference, which
writes it in jnp), pre-scaled by GradScale so that its RMS sits in the
map's high-resolution region; the second moment in 8 bits through the
blockwise dynamic codec (``kernels.blockwise_quant``: K8a / K8b on the
card). Per JAX leaf, as ``lowbit`` (see ``optim.base``): the size threshold,
the 256-value blocks and GradScale's RMS are over the whole stacked leaf.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.blockwise_quant import dequantize, quantize
from repro_torch.optim.base import Optimizer, check_groups, gather, scatter
from repro_torch.optim.optimizers import LR, _lr_at

MIN_SIZE = 4096
BLOCK = 256


@functools.lru_cache(maxsize=None)
def dynamic_map_4bit() -> np.ndarray:
    """16 signed codes: 3 exponent decades x linear fractions + {0, 1}."""
    pos = []
    for i in range(3):
        boundaries = np.linspace(0.1, 1.0, 2**i + 1)
        means = (boundaries[:-1] + boundaries[1:]) / 2.0
        pos += (10.0 ** (i - 2) * means).tolist()
    assert len(pos) == 7
    data = pos + [-v for v in pos] + [0.0, 1.0]
    data.sort()
    out = np.asarray(data, dtype=np.float32)
    assert out.shape == (16,)
    return out


def quantize4(x: torch.Tensor, block: int = BLOCK):
    """(codes uint8 [0..15], scales) — the blockwise scaffold over the 4-bit map."""
    codes = torch.from_numpy(dynamic_map_4bit()).to(x.device)
    xb = x.reshape(-1, block).float()
    scale = torch.amax(torch.abs(xb), dim=1, keepdim=True)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    normed = xb / safe
    mid = (codes[1:] + codes[:-1]) / 2.0
    idx = torch.searchsorted(mid, normed, right=True).to(torch.uint8)
    return idx.reshape(-1), scale[:, 0]


def dequantize4(idx: torch.Tensor, scale: torch.Tensor, block: int = BLOCK):
    codes = torch.from_numpy(dynamic_map_4bit()).to(idx.device)
    vals = codes[idx.long()].reshape(-1, block)
    return (vals * scale[:, None]).reshape(-1)


def grad_scale(g: torch.Tensor, target_rms: float = 0.3) -> torch.Tensor:
    """Adaptive Gradient Scaling: per-leaf scale putting the RMS of the
    normalized moment near the map's high-resolution region."""
    rms = torch.sqrt(torch.mean(torch.square(g))) + 1e-12
    return target_rms / rms


def _pad_to_block(x: torch.Tensor) -> torch.Tensor:
    pad = (-x.numel()) % BLOCK
    return F.pad(x.reshape(-1), (0, pad)) if pad else x.reshape(-1)


def adam4bit(
    lr: LR = 3e-4,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> Optimizer:
    """Adam with a 4-bit first moment (+GradScale) and an 8-bit second moment."""

    def init(params, groups=None):
        groups = check_groups(len(params), groups)
        dev = params[0].device
        slots = []
        for group in groups:
            n = sum(params[i].numel() for i in group)
            if n >= MIN_SIZE:
                z = _pad_to_block(torch.zeros(n, dtype=torch.float32, device=dev))
                c4, s4 = quantize4(z)
                c8, s8, _ = quantize(z)
                slots.append({"m4": {"codes": c4, "scales": s4},
                              "v8": {"codes": c8, "scales": s8},
                              "gs": torch.ones((), dtype=torch.float32, device=dev)})
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
            gf = gather(grads, group)
            n = gf.numel()
            big = n >= MIN_SIZE
            if big:
                padded = _pad_to_block(gf).numel()
                m = dequantize4(slot["m4"]["codes"], slot["m4"]["scales"])[:n] / slot["gs"]
                v = dequantize(slot["v8"]["codes"], slot["v8"]["scales"],
                               padded, (padded,))[:n]
            else:
                m, v = slot["m"], slot["v"]
            m = b1 * m + (1 - b1) * gf
            v = b2 * v + (1 - b2) * torch.square(gf)
            u = -lr_t * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if big:
                gs = grad_scale(m)                   # scale the MOMENT stream
                c4, s4 = quantize4(_pad_to_block(m * gs))
                c8, s8, _ = quantize(_pad_to_block(v))
                new = {"m4": {"codes": c4, "scales": s4},
                       "v8": {"codes": c8, "scales": s8}, "gs": gs}
            else:
                new = {"m": m, "v": v}
            return new, u

        updates = [None] * len(grads)
        slots = []
        for slot, group in zip(state["slots"], state["groups"]):
            new, u = leaf(slot, group)
            slots.append(new)
            for i, t in zip(group, scatter(u, grads, group)):
                updates[i] = t
        return updates, {"slots": slots, "step": step, "groups": state["groups"]}

    return Optimizer(init, update)
