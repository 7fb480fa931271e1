"""Activation stash: the storage of the pipeline runner's slot buffers.

Counterpart of ``repro.core.stash``. The host-driven 1F1B/GPipe runner
(``core.pipeline.pipeline_grads_host``) keeps ``tick_table.n_act_slots``
stage inputs per stage, each written once and read by its forward and then
by its backward. A backend decides how a slot is stored:

* ``RawStash``   — the native dtype, bit for bit.
* ``QuantStash`` — blockwise int8 / fp8 codes (256 values a block) and one
                   f32 scale per block (``kernels.blockwise_quant.
                   stash_quantize``: K7a / K7b on the card). Every forward
                   consumes the dequantized value, and stage 0's recompute
                   re-applies the codec through the straight-through
                   ``roundtrip``, so the gradients are those of the
                   perturbed forward that ran.
* ``HostStash``  — the newest ``window`` slots stay on the device; older
                   ones are copied to pinned host memory on a side stream
                   and brought back ahead of their backward by ``prefetch``.
                   Values round-trip bit for bit.

What differs from JAX:

* State is preallocated tensors updated in place (JAX returned new state).
  ``put`` writes into the slot's rows of ``state``: K7a writes its codes and
  scales straight into them. ``RawStash.get`` returns a view of the slot,
  valid until the slot's next ``put``; the runner consumes it within the
  tick.
* A slot holds one tensor, described by a :class:`SlotSpec` (shape, dtype,
  device), where JAX takes a pytree of ``ShapeDtypeStruct``.
* There is no ``scan_capable`` flag and no ``codec_backend`` /
  ``fused`` choice: the port has only the host-driven runner, and the codec
  goes by the tensor's device.
* ``HostStash`` starts a slot's device->host copy when the slot leaves the
  window, not at every put, so a slot read from the window never crosses the
  bus; JAX's ``copy_to_host_async`` / ``is_ready`` become a
  ``non_blocking`` copy on a side stream, ordered after the producer by an
  event, and ``Event.query()``. The counters are JAX's.

Byte accounting (``slot_bytes``, ``device_bytes``, ``host_bytes``,
``state_bytes``) is exact, as in JAX.
"""
from __future__ import annotations

import collections
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.blockwise_quant.ops import (
    STASH_BLOCK,
    stash_dequantize,
    stash_padded_size,
    stash_quantize,
    stash_storage_dtype,
)
from repro_torch.kernels.paged_attention.quant import SCALE_BYTES

STASH_BACKENDS = ("raw", "int8", "fp8", "host")


def normalize_stash(stash: str) -> str:
    """Canonical backend name ('' and 'bf16'/'native' mean raw)."""
    if stash in ("", "raw", "native", "bf16"):
        return "raw"
    if stash not in STASH_BACKENDS:
        raise ValueError(f"stash {stash!r} not in {STASH_BACKENDS}")
    return stash


class SlotSpec(NamedTuple):
    """What one slot holds: the counterpart of a ``ShapeDtypeStruct``."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device

    @property
    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n

    @property
    def nbytes(self) -> int:
        return self.numel * self.dtype.itemsize


class RawStash:
    """Slots are one ``(n_slots, *shape)`` buffer of the native dtype."""

    name = "raw"
    cotangents = False

    def init(self, n_slots: int, spec: SlotSpec) -> torch.Tensor:
        return torch.zeros((n_slots,) + tuple(spec.shape), dtype=spec.dtype,
                           device=spec.device)

    @torch.no_grad()
    def put(self, state: torch.Tensor, slot: int, value: torch.Tensor) -> torch.Tensor:
        state[slot].copy_(value)
        return state

    def get(self, state: torch.Tensor, slot: int, spec: SlotSpec) -> torch.Tensor:
        return state[slot]

    def roundtrip(self, value: torch.Tensor) -> torch.Tensor:
        return value

    def prefetch(self, state, slot: int) -> None:
        """Overlap hook (no-op: slots are already on the device)."""

    def poll(self, state) -> None:
        """Overlap hook (no-op: nothing is ever in flight)."""

    def slot_bytes(self, spec: SlotSpec) -> int:
        """Exact stored bytes of ONE slot."""
        return spec.nbytes

    def device_bytes(self, n_slots: int, spec: SlotSpec) -> int:
        return n_slots * self.slot_bytes(spec)

    def host_bytes(self, n_slots: int, spec: SlotSpec) -> int:
        return 0

    def state_bytes(self, n_slots: int, spec: SlotSpec) -> int:
        return self.device_bytes(n_slots, spec)


class _StashRoundtrip(torch.autograd.Function):
    """Straight-through quantize -> dequantize: the forward is the stash's
    perturbation (the bits of put-then-get), the backward the identity — the
    counterpart of JAX's ``_ste_roundtrip`` custom_vjp."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, storage: str) -> torch.Tensor:
        codes, scales = stash_quantize(x, storage)
        return stash_dequantize(codes, scales, tuple(x.shape), x.dtype)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


class QuantStash:
    """Blockwise int8 / fp8 slots: codes ``(n_slots, nblocks, 256)`` (the
    value zero-padded to the block multiple) and scales ``(n_slots,
    nblocks)`` f32. ``cotangents=True`` asks the runner to pass the pipeline's
    cotangents through the same codec."""

    def __init__(self, storage: str = "fp8", cotangents: bool = False):
        if storage not in ("int8", "fp8"):
            raise ValueError(f"QuantStash storage {storage!r}")
        self.storage = storage
        self.cotangents = bool(cotangents)

    @property
    def name(self) -> str:
        return self.storage

    def init(self, n_slots: int, spec: SlotSpec) -> Dict[str, torch.Tensor]:
        nb = stash_padded_size(spec.numel) // STASH_BLOCK
        codes = torch.zeros((n_slots, nb, STASH_BLOCK), dtype=torch.uint8,
                            device=spec.device)
        return {
            "codes": codes.view(stash_storage_dtype(self.storage)),
            "scales": torch.zeros((n_slots, nb), dtype=torch.float32, device=spec.device),
        }

    @torch.no_grad()
    def put(self, state: Dict[str, torch.Tensor], slot: int,
            value: torch.Tensor) -> Dict[str, torch.Tensor]:
        stash_quantize(value, self.storage,
                       out=(state["codes"][slot], state["scales"][slot]))
        return state

    def get(self, state: Dict[str, torch.Tensor], slot: int,
            spec: SlotSpec) -> torch.Tensor:
        return stash_dequantize(state["codes"][slot], state["scales"][slot],
                                spec.shape, spec.dtype)

    def roundtrip(self, value: torch.Tensor) -> torch.Tensor:
        return _StashRoundtrip.apply(value, self.storage)

    def prefetch(self, state, slot: int) -> None:
        """Overlap hook (no-op: codes and scales stay on the device)."""

    def poll(self, state) -> None:
        """Overlap hook (no-op: nothing is ever in flight)."""

    def slot_bytes(self, spec: SlotSpec) -> int:
        """Exact stored bytes per slot: padded codes + per-block f32 scales."""
        padded = stash_padded_size(spec.numel)
        return padded + (padded // STASH_BLOCK) * SCALE_BYTES

    def device_bytes(self, n_slots: int, spec: SlotSpec) -> int:
        return n_slots * self.slot_bytes(spec)

    def host_bytes(self, n_slots: int, spec: SlotSpec) -> int:
        return 0

    def state_bytes(self, n_slots: int, spec: SlotSpec) -> int:
        return self.device_bytes(n_slots, spec)


# a copy to host: (host tensor, the event its copy completes at; None on the CPU)
_Copy = Tuple[torch.Tensor, Optional[torch.cuda.Event]]


class _HostSlotStore:
    """One stage's slots under HostStash, in four residency sets:

    * ``device``  — the newest ``window`` slots, FIFO;
    * ``pending`` — evicted slots whose device->host copy may still be in
                    flight, with the device tensor kept alive so that a get
                    before the copy lands needs no transfer;
    * ``host``    — slots whose copy has landed (``poll``, once
                    ``Event.query()`` says so: the overlapped eviction);
    * ``staged``  — device copies brought back ahead of a backward's get
                    (``prefetch``). A get served from here is a prefetch
                    hit; a get that must transfer inline is a *stall*.

    Values round-trip bit for bit on every path; only the counters differ
    between the eager (lookahead 0) and the overlapped runner."""

    def __init__(self, window: int):
        self.window = int(window)
        self.device: "collections.OrderedDict[int, torch.Tensor]" = collections.OrderedDict()
        self.pending: Dict[int, Tuple[torch.Tensor, _Copy]] = {}
        self.host: Dict[int, _Copy] = {}
        self.staged: Dict[int, _Copy] = {}
        self.stats = {
            "puts": 0, "gets": 0, "evictions": 0, "host_hits": 0,
            "window_hits": 0, "host_bytes_high_water": 0,
            "overlapped_evictions": 0, "prefetch_issued": 0,
            "prefetch_hits": 0, "stalled_gets": 0,
        }
        self._streams: Dict[str, torch.cuda.Stream] = {}
        self._dev: Optional[torch.device] = None      # the slots' device

    def _stream(self, which: str, dev: torch.device) -> torch.cuda.Stream:
        if which not in self._streams:
            self._streams[which] = torch.cuda.Stream(dev)
        return self._streams[which]

    def _to_host(self, value: torch.Tensor) -> _Copy:
        """Start the device->host copy of an evicted slot: on a side stream
        that first waits for the stream that produced it, into pinned memory.
        ``record_stream`` keeps the device tensor's memory from being reused
        before the copy has read it, whenever the tensor is dropped."""
        if value.device.type != "cuda":
            return value.detach().clone(), None
        side = self._stream("d2h", value.device)
        side.wait_stream(torch.cuda.current_stream(value.device))
        host = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
        with torch.cuda.stream(side):
            host.copy_(value, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        value.record_stream(side)
        return host, done

    def _to_device(self, copy: _Copy, dev: torch.device) -> _Copy:
        """Start the host->device load of a landed slot on the other side
        stream, after its device->host copy."""
        host, done = copy
        if done is None:
            return host, None
        side = self._stream("h2d", dev)
        side.wait_event(done)
        with torch.cuda.stream(side):
            value = host.to(dev, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(side)
        return value, ready

    @staticmethod
    def _use(copy: _Copy) -> torch.Tensor:
        """A loaded slot, made safe to read on the current stream."""
        value, ready = copy
        if ready is not None:
            cur = torch.cuda.current_stream(value.device)
            cur.wait_event(ready)
            value.record_stream(cur)
        return value

    def _host_bytes(self) -> int:
        """Host-destined bytes: landed copies plus evictions in flight."""
        return (sum(h.nbytes for h, _ in self.host.values())
                + sum(h.nbytes for _, (h, _) in self.pending.values()))

    def put(self, slot: int, value: torch.Tensor) -> None:
        # Slot reuse drops every stale copy (landed, in flight, prefetched).
        self.host.pop(slot, None)
        self.pending.pop(slot, None)
        self.staged.pop(slot, None)
        self.device.pop(slot, None)
        self.device[slot] = value
        self._dev = value.device
        self.stats["puts"] += 1
        while len(self.device) > self.window:
            # Eviction never blocks: the copy starts here and the slot waits
            # in ``pending`` until poll or get sees it land.
            old_slot, old_val = self.device.popitem(last=False)
            self.pending[old_slot] = (old_val, self._to_host(old_val))
            self.stats["evictions"] += 1
        self.stats["host_bytes_high_water"] = max(
            self.stats["host_bytes_high_water"], self._host_bytes()
        )

    def poll(self) -> None:
        """Land every pending eviction whose copy has completed (once per
        tick, from the runner), releasing its device memory."""
        for slot in list(self.pending):
            _, copy = self.pending[slot]
            if copy[1] is None or copy[1].query():
                self.host[slot] = copy
                del self.pending[slot]
                self.stats["overlapped_evictions"] += 1

    def prefetch(self, slot: int) -> None:
        """Start the host->device load for an upcoming backward's slot. A
        window or staged slot is a no-op; a pending slot's device tensor is
        still alive, so staging it costs no transfer."""
        if slot in self.device or slot in self.staged:
            return
        if slot in self.pending:
            self.staged[slot] = (self.pending[slot][0], None)
            self.stats["prefetch_issued"] += 1
            return
        if slot in self.host:
            self.staged[slot] = self._to_device(self.host[slot], self._dev)
            self.stats["prefetch_issued"] += 1

    def get(self, slot: int) -> torch.Tensor:
        self.stats["gets"] += 1
        if slot in self.device:
            self.stats["window_hits"] += 1
            return self.device[slot]
        self.stats["host_hits"] += 1
        staged = self.staged.pop(slot, None)
        if staged is not None:
            self.stats["prefetch_hits"] += 1
            return self._use(staged)
        # Neither in the window nor prefetched: the get transfers inline,
        # the stall that the lookahead exists to remove.
        self.stats["stalled_gets"] += 1
        if slot in self.pending:
            value, copy = self.pending.pop(slot)
            self.host[slot] = copy
            return value
        return self._use(self._to_device(self.host[slot], self._dev))


class HostStash:
    """Device -> host slot eviction behind a device window of ``window``
    slots (vDNN applied to the pipeline's stash). Slot indices are host ints:
    this backend pairs with the host-driven runner."""

    name = "host"
    cotangents = False

    def __init__(self, window: int = 2):
        self.window = int(window)
        # the counters of every store handed out (one per stage and step);
        # the stores themselves, and their tensors, die with the runner
        self.counters: list = []

    def init(self, n_slots: int, spec: SlotSpec) -> _HostSlotStore:
        store = _HostSlotStore(self.window)
        self.counters.append(store.stats)
        return store

    def put(self, state: _HostSlotStore, slot: int, value: torch.Tensor) -> _HostSlotStore:
        state.put(int(slot), value)
        return state

    def get(self, state: _HostSlotStore, slot: int, spec: SlotSpec) -> torch.Tensor:
        return state.get(int(slot))

    def roundtrip(self, value: torch.Tensor) -> torch.Tensor:
        return value

    def prefetch(self, state: _HostSlotStore, slot: int) -> None:
        """Start the host->device load of ``slot`` ahead of its get."""
        state.prefetch(int(slot))

    def poll(self, state: _HostSlotStore) -> None:
        """Retire completed evictions (once per tick)."""
        state.poll()

    def slot_bytes(self, spec: SlotSpec) -> int:
        """Bytes of one slot while it sits in the device window (its host
        copy is the same size)."""
        return spec.nbytes

    def device_bytes(self, n_slots: int, spec: SlotSpec) -> int:
        """Only the window stays on the device."""
        return min(self.window, n_slots) * self.slot_bytes(spec)

    def host_bytes(self, n_slots: int, spec: SlotSpec) -> int:
        """Every slot beyond the window lands on the host (steady-state high
        water; copies in flight count)."""
        return max(0, n_slots - self.window) * self.slot_bytes(spec)

    def state_bytes(self, n_slots: int, spec: SlotSpec) -> int:
        """Device-resident bytes (alias of ``device_bytes``)."""
        return self.device_bytes(n_slots, spec)

    def stats(self) -> Dict[str, int]:
        """Counters summed over every store this backend handed out."""
        out: Dict[str, int] = {}
        for c in self.counters:
            for k, v in c.items():
                out[k] = out.get(k, 0) + v
        return out


def get_backend(stash: str, *, host_window: int = 2, cotangents: bool = False):
    """``raw | int8 | fp8 | host`` -> a backend. ``cotangents=True`` (the
    quantized backends only) asks the runner to pass cotangents through the
    codec too."""
    s = normalize_stash(stash)
    if cotangents and s not in ("int8", "fp8"):
        raise ValueError(f"cotangents=True needs a quantized stash, got {s!r}")
    if s == "raw":
        return RawStash()
    if s in ("int8", "fp8"):
        return QuantStash(s, cotangents=cotangents)
    return HostStash(window=host_window)
