"""Runtime knobs threaded through model application (not part of ArchConfig).

The serving half of ``repro.models.runtime.Runtime``: only the fields the
paged serving path reads. Kernel routing is not a knob here — the ops choose
by the tensor's device (``kernels.paged_attention.ops``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class Runtime:
    dtype: Any = torch.bfloat16      # compute dtype of activations and pools
    # Paged KV pool storage dtype: "" = native (pools stored at ``dtype``).
    # Quantized pools ("int8" / "fp8") belong to a later slice.
    kv_dtype: str = ""
    long_variant: bool = False       # run the sliding-window long-context variant

    def replace(self, **kw) -> "Runtime":
        return dataclasses.replace(self, **kw)
