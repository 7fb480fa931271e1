"""The activation stash's closed forms: bytes per slot, capacity factor,
and the pipeline state's device and host bytes.

Counterpart of the stash part of ``repro.roofline.analysis``
(``stash_bytes_per_slot``, ``predicted_stash_capacity_factor``,
``predicted_pipeline_stash_bytes``, ``predicted_stash_host_bytes``, and
``predicted_stage_transient_bytes``, which ``ParallelPlan.stash_report``
needs), copied as they are: pure arithmetic on sizes, the same on any
device. The rest of that module prices a TPU and waits to be re-priced for
the H100 (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

from repro_torch.core.stash import normalize_stash


def stash_bytes_per_slot(
    n_elems: int, stash: str = "raw", native_itemsize: int = 2,
    block: int = 256,
) -> int:
    """Exact bytes one pipeline activation slot occupies under a stash
    backend. ``raw``/``host`` store the native dtype (host's device window is
    raw-width; the caller multiplies by the window, not the slot count).
    ``int8``/``fp8`` store 1-byte codes zero-padded to the block multiple plus
    one f32 scale per block — what ``QuantStash.slot_bytes`` counts."""
    s = normalize_stash(stash)
    if s in ("raw", "host"):
        return n_elems * native_itemsize
    padded = (n_elems + block - 1) // block * block
    return padded + (padded // block) * 4   # SCALE_BYTES


def predicted_stash_capacity_factor(
    n_elems: int, stash: str, native_itemsize: int = 2, block: int = 256,
) -> float:
    """Per-slot byte ratio raw : ``stash`` (2 / (1 + 4/256) = 1.97 for
    int8/fp8 against bf16)."""
    return (
        stash_bytes_per_slot(n_elems, "raw", native_itemsize, block)
        / stash_bytes_per_slot(n_elems, stash, native_itemsize, block)
    )


def predicted_pipeline_stash_bytes(
    n_elems: int, n_act_slots: int, n_cot_slots: int, stash: str,
    native_itemsize: int = 2, block: int = 256, host_window: int = 2,
    cot_stash: str = "raw",
) -> int:
    """Device-resident pipeline state per stage: activation slots at the
    stash's width plus cotangent slots at ``cot_stash``'s (native unless the
    backend compresses cotangents). ``host`` keeps only ``host_window``
    activation slots on the device."""
    s = normalize_stash(stash)
    act_slots = min(host_window, n_act_slots) if s == "host" else n_act_slots
    act = act_slots * stash_bytes_per_slot(n_elems, s, native_itemsize, block)
    cot = n_cot_slots * stash_bytes_per_slot(
        n_elems, cot_stash, native_itemsize, block
    )
    return act + cot


def predicted_stash_host_bytes(
    n_elems: int, n_act_slots: int, stash: str, native_itemsize: int = 2,
    block: int = 256, host_window: int = 2,
) -> int:
    """Host-memory high water of the stash: every activation slot beyond the
    device window, at native width, for ``host`` (copies in flight count);
    zero for the device-resident backends."""
    if normalize_stash(stash) != "host":
        return 0
    spill = max(0, n_act_slots - host_window)
    return spill * stash_bytes_per_slot(n_elems, "raw", native_itemsize, block)


def predicted_stage_transient_bytes(
    n_elems: int, layers_per_stage: int, remat: str = "none",
    native_itemsize: int = 2,
) -> int:
    """Within-stage backward transient: the runner recomputes a stage from
    its stored input, so autograd holds one inter-layer activation per layer
    of the stage — one layer's worth under per-stage full remat."""
    live_layers = 1 if remat == "full" else layers_per_stage
    return live_layers * n_elems * native_itemsize
