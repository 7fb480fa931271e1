"""Runtime knobs threaded through model application (not part of ArchConfig).

The fields of ``repro.models.runtime.Runtime`` that the ported paths read:
paged serving and the single-device training step. Kernel routing is not a
knob here — the ops choose by the tensor's device (``repro_torch.kernels``),
so the JAX ``use_flash_kernel`` / ``use_paged_kernel`` flags have no
counterpart, and ``fused_backward`` only picks the loss head.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

REMAT_MODES = ("none", "full", "dots")


@dataclasses.dataclass(frozen=True)
class Runtime:
    dtype: Any = torch.bfloat16      # compute dtype of activations and pools
    # Paged KV pool storage dtype: "" = native (pools stored at ``dtype``);
    # "int8" / "fp8" store codes and one f32 scale per (page slot, kv head)
    # (``kernels.paged_attention.quant``)
    kv_dtype: str = ""
    long_variant: bool = False       # run the sliding-window long-context variant
    remat: str = "none"              # none | full | dots (offload: later slice)
    # checkpoint granularity: this many layers per checkpoint (remat full/dots)
    remat_period: int = 1
    # the vocab-chunked cross-entropy head, which never holds (B, S, V)
    # logits, instead of the dense f32 logits head
    fused_backward: bool = False
    ce_chunk: int = 2048             # vocab chunk of the chunked CE head

    def __post_init__(self):
        if self.remat == "offload":
            raise NotImplementedError(
                "remat='offload' (host offload of saved activations) is ROADMAP "
                "queue 1 item 6, 'memory techniques and multi-device'"
            )
        if self.remat not in REMAT_MODES:
            raise ValueError(f"remat {self.remat!r} not in {REMAT_MODES}")
        if self.remat_period < 1:
            raise ValueError(f"remat_period {self.remat_period} < 1")

    def replace(self, **kw) -> "Runtime":
        return dataclasses.replace(self, **kw)
