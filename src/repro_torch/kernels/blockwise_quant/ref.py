"""Plain PyTorch version of the blockwise dynamic 8-bit codec (K8a, K8b).

Counterpart of ``repro.kernels.blockwise_quant.ref``. ``dynamic_map`` is a
verbatim copy (numpy, f32): the dynamic data type of Dettmers et al. 2021 —
1 sign bit, a variable-length exponent prefix and a linear mantissa, giving
high relative precision near zero and coverage up to 1.0.

Quantization is blockwise: per block of ``BLOCK`` values, scale = absmax,
then the nearest code in the map, found as a right searchsorted over the f32
midpoints between neighbouring codes. State = (codes uint8, scales f32).
These are what ``ops`` runs for CPU tensors, and what ``chip_smoke.py``
holds each CUDA kernel against, bitwise.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

BLOCK = 256


@functools.lru_cache(maxsize=None)
def dynamic_map(signed: bool = True, total_bits: int = 8) -> np.ndarray:
    """The 2^total_bits sorted code values in [-1, 1].

    Dynamic-exponent construction (Dettmers'21): 7 exponent levels, level i
    holding 2^i linear fractions of the decade 10^(i-6) — dense relative
    precision near zero, coverage to 1.0. Exactly 127 positive codes
    (+ mirrored negatives + {0, 1}) = 256.
    """
    assert signed and total_bits == 8, "only the signed 8-bit map is used"
    pos = []
    for i in range(7):
        boundaries = np.linspace(0.1, 1.0, 2**i + 1)
        means = (boundaries[:-1] + boundaries[1:]) / 2.0
        pos += (10.0 ** (i - 6) * means).tolist()
    assert len(pos) == 127
    data = pos + [-v for v in pos] + [0.0, 1.0]
    data.sort()
    out = np.asarray(data, dtype=np.float32)
    assert out.shape == (256,), out.shape
    return out


def code_table(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(map (256,), midpoints (255,)), both f32 on ``device``; the midpoints
    are ``(map[1:] + map[:-1]) / 2`` in f32, as the reference computes them."""
    codes = torch.from_numpy(dynamic_map()).to(device)
    return codes, (codes[1:] + codes[:-1]) / 2.0


SEARCH_PAD = 32                     # K8a's table: one pad word every 32 midpoints


def search_table(device) -> torch.Tensor:
    """K8a's midpoint table (f32 (132,) on ``device``): the 128 positive
    midpoints P_m = mid[127 + m] with P_m at index m + m // 32, and +inf in
    the four pad slots, which the kernel never reads. The pad puts each of
    its search steps' candidates in distinct shared-memory banks but the
    last's, two to a bank (``csrc/blockwise_quant.cu``). The kernel searches
    |v| there and mirrors the count for v < 0, which needs mid[126 - m] ==
    -mid[127 + m] for m < 127: checked here."""
    _, mid = code_table("cpu")
    pos = mid[127:]
    if not torch.equal(mid[:127], -pos[:127].flip(0)):
        raise AssertionError("the midpoints are not symmetric about 0 below the top one")
    m = torch.arange(pos.numel())
    table = torch.full((pos.numel() + pos.numel() // SEARCH_PAD,), float("inf"))
    table[m + m // SEARCH_PAD] = pos
    return table.to(device)


def quantize_ref(x: torch.Tensor, block: int = BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: flat f32 (n,), n % block == 0 -> (codes uint8 (n,), scales f32 (n/block,))."""
    _, mid = code_table(x.device)
    xb = x.reshape(-1, block).float()
    scale = torch.amax(torch.abs(xb), dim=1, keepdim=True)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    normed = xb / safe
    idx = torch.searchsorted(mid, normed, right=True).to(torch.uint8)
    return idx.reshape(-1), scale[:, 0]


def dequantize_ref(idx: torch.Tensor, scale: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    codes, _ = code_table(idx.device)
    vals = codes[idx.long()].reshape(-1, block)
    return (vals * scale[:, None]).reshape(-1)
