"""The executable pipeline plan (counterpart of ``repro.core.partitioner``'s
``ParallelPlan``).

A plan carries the (data, model, pipe) degrees, the microbatch count, the
executable schedule, equal-count stage boundaries, the per-stage remat
policy and the activation stash (``core.stash``). ``validate`` checks it
against a config, including the activation budget and the host stash's rule
dp = tp = 1; ``stash_report`` prices its pipeline state with the closed
forms of ``roofline.analysis``. On one card every plan with ``pp > 1`` runs
on the host-driven runner (``core.pipeline.pipeline_grads_host``).

The partition searches (``dynprog_partition``, ``dp_pp_search``) and
``auto_plan`` wait for the multi-device pipeline, ROADMAP queue 1 item 7.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """dp/tp/pp: the (data, model, pipe) degrees; ``microbatches`` and
    ``schedule`` drive the tick tables; ``boundaries`` cut the layers into
    contiguous equal-count stages; ``remat`` applies inside every stage (the
    runner already recomputes each stage from its stored input, so this
    bounds the within-stage transient only); ``stash`` picks the slot
    storage (raw | int8 | fp8 | host); ``stash_cot`` also passes cotangents
    through the codec (quantized stashes only)."""
    dp: int = 1
    tp: int = 1
    pp: int = 1
    microbatches: int = 1
    schedule: str = "1f1b"
    boundaries: Tuple[int, ...] = ()
    remat: str = "none"
    stash: str = "raw"
    stash_cot: bool = False

    @property
    def n_devices(self) -> int:
        return self.dp * self.tp * self.pp

    def stage_boundaries(self, n_layers: int) -> Tuple[int, ...]:
        if self.boundaries:
            return self.boundaries
        step = n_layers // self.pp
        return tuple(range(0, n_layers + 1, step))

    def validate(
        self,
        cfg: ArchConfig,
        *,
        global_batch: Optional[int] = None,
        seq_len: Optional[int] = None,
        act_budget: Optional[int] = None,
        itemsize: int = 2,
    ) -> "ParallelPlan":
        """Check executability against ``cfg``; returns self. With
        ``act_budget`` (bytes of pipeline activation state a device may
        hold; needs ``global_batch`` and ``seq_len``) also check that the
        stash fits."""
        from repro_torch.core.pipeline import EXECUTABLE_SCHEDULES
        from repro_torch.core.stash import normalize_stash
        from repro_torch.models.stack import pipeline_incompatibility

        stash = normalize_stash(self.stash)
        if self.schedule not in EXECUTABLE_SCHEDULES:
            raise ValueError(
                f"schedule {self.schedule!r} is simulator-only; executable: "
                f"{EXECUTABLE_SCHEDULES}"
            )
        if min(self.dp, self.tp, self.pp, self.microbatches) < 1:
            raise ValueError(f"degenerate plan {self}")
        if stash == "host" and (self.dp, self.tp) != (1, 1):
            raise ValueError(
                "stash='host' uses the host-driven runner (single device "
                f"per stage); got dp={self.dp} tp={self.tp}"
            )
        if self.stash_cot and stash not in ("int8", "fp8"):
            raise ValueError(f"stash_cot=True needs a quantized stash, got {self.stash!r}")
        if cfg.n_layers % self.pp:
            raise ValueError(f"{cfg.n_layers} layers not divisible into pp={self.pp} stages")
        b = self.stage_boundaries(cfg.n_layers)
        sizes = {b[i + 1] - b[i] for i in range(len(b) - 1)}
        if len(b) != self.pp + 1 or len(sizes) != 1:
            raise ValueError(f"non-uniform stage boundaries {b} for pp={self.pp}")
        why = pipeline_incompatibility(cfg)
        if why is not None:
            raise ValueError(f"plan incompatible with {cfg.name}: {why}")
        if act_budget is not None:
            if global_batch is None or seq_len is None:
                raise ValueError("act_budget check needs global_batch and seq_len")
            rep = self.stash_report(cfg, global_batch=global_batch, seq_len=seq_len,
                                    itemsize=itemsize)
            if rep["total_bytes"] > act_budget:
                raise ValueError(
                    f"activation state {rep['total_bytes']} B (slots "
                    f"{rep['act_bytes']} B + within-stage transient "
                    f"{rep['transient_bytes']} B) exceeds budget "
                    f"{act_budget} B at stash={rep['backend']} "
                    f"remat={self.remat} "
                    f"(raw slots would need {rep['raw_act_bytes']} B; "
                    f"capacity factor {rep['capacity_factor']:.2f}x)"
                )
        return self

    def stash_report(
        self, cfg: ArchConfig, *, global_batch: int, seq_len: int, itemsize: int = 2,
    ) -> dict:
        """Predicted pipeline activation-state bytes per stage under this
        plan's stash: ``act_bytes`` (alias ``device_bytes``) the slots on the
        device, ``host_bytes`` what a host stash spills, ``transient_bytes``
        the within-stage backward transient that ``remat`` controls, and
        ``total_bytes`` = slots + transient, what ``validate(act_budget=)``
        gates on."""
        from repro_torch.core.pipeline import tick_table
        from repro_torch.core.stash import normalize_stash
        from repro_torch.roofline.analysis import (
            predicted_pipeline_stash_bytes,
            predicted_stage_transient_bytes,
            predicted_stash_host_bytes,
            stash_bytes_per_slot,
        )

        s = normalize_stash(self.stash)
        cot_s = s if (self.stash_cot and s in ("int8", "fp8")) else "raw"
        table = tick_table(self.schedule, self.pp, self.microbatches)
        mb = global_batch // (self.dp * self.microbatches)
        n_elems = mb * seq_len * cfg.d_model // self.tp
        raw_slot = stash_bytes_per_slot(n_elems, "raw", itemsize)
        act = predicted_pipeline_stash_bytes(
            n_elems, table.n_act_slots, table.n_cot_slots, s, itemsize, cot_stash=cot_s,
        )
        raw = predicted_pipeline_stash_bytes(
            n_elems, table.n_act_slots, table.n_cot_slots, "raw", itemsize
        )
        host = predicted_stash_host_bytes(n_elems, table.n_act_slots, s, itemsize)
        transient = predicted_stage_transient_bytes(
            n_elems, cfg.n_layers // self.pp, self.remat, itemsize
        )
        return {
            "backend": s,
            "remat": self.remat,
            "stash_cot": cot_s != "raw",
            "n_act_slots": table.n_act_slots,
            "n_cot_slots": table.n_cot_slots,
            "bytes_per_slot": stash_bytes_per_slot(n_elems, s, itemsize),
            "raw_bytes_per_slot": raw_slot,
            "act_bytes": act,
            "device_bytes": act,
            "host_bytes": host,
            "transient_bytes": transient,
            "total_bytes": act + transient,
            "raw_act_bytes": raw,
            "capacity_factor": raw / max(act, 1),
        }

    def describe(self) -> str:
        return (
            f"dp={self.dp} tp={self.tp} pp={self.pp} "
            f"M={self.microbatches} schedule={self.schedule} "
            f"remat={self.remat} stash={self.stash}"
        )
