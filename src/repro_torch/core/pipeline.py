"""Pipeline parallelism: Table-4 schedules, their simulator, the tick tables
and the host-driven 1F1B/GPipe runner.

Counterpart of ``repro.core.pipeline``:

1. **Schedule generators and the event-driven simulator** (``Op``,
   ``SimResult``, ``simulate``): a verbatim copy (pure Python and numpy).
2. **The mesh runners** ``pipeline_apply`` and ``pipeline_grads`` run under
   ``shard_map`` across P devices in JAX; here they raise
   ``NotImplementedError`` (ROADMAP queue 1 item 7, which needs
   ``torch.distributed``).
3. **Tick tables** (``TickTable``, ``tick_table``): a verbatim copy — the
   simulator run at unit cost, compiled into per-(tick, stage) integer
   tables of microbatches and slots — and ``pipeline_grads_host``, the
   runner that executes them as a Python loop on ONE device: every stage's
   op of a tick in turn, the inter-stage traffic through per-stage wires (a
   value sent at tick t lands at t + 1, the table's contract).

In ``pipeline_grads_host`` an F op runs under ``torch.no_grad()``, so a
stage keeps nothing alive but its slot buffers; a B op recomputes the stage
under ``enable_grad`` from the slot's value and calls ``torch.autograd.grad``
on (y, loss) against the stage's parameters, the shared parameters and the
saved input — per-stage rematerialization by construction, and the
counterpart of JAX's ``jax.vjp`` per microbatch. Gradients accumulate in f32
per parameter in the tick order of the table, as JAX's do.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.stash import RawStash, SlotSpec

MESH_RUNNERS = ("the P-device pipeline runners (shard_map in JAX) need torch.distributed: "
                "ROADMAP queue 1 item 7")

# =====================================================================
# Part 1: schedules + simulator
# =====================================================================

F, B = "F", "B"


@dataclasses.dataclass(frozen=True)
class Op:
    stage: int           # virtual stage index in [0, P*v)
    mb: int
    kind: str            # F | B


@dataclasses.dataclass(frozen=True)
class SimResult:
    name: str
    makespan: float
    bubble_fraction: float
    peak_activations: int        # per device, in microbatch-activation units
    weight_versions: int
    synchronous: bool
    max_staleness: int           # in optimizer steps (async only)


def _device_of(vstage: int, P: int, placement: str, v: int) -> int:
    if placement == "interleaved":
        return vstage % P
    if placement == "bidirectional":      # chimera/gems: chunk0 = s, chunk1 = P-1-s
        chunk, s = divmod(vstage, P)
        return s if chunk == 0 else P - 1 - s
    return vstage  # plain: one stage per device


def _op_order(name: str, P: int, M: int, v: int) -> Tuple[List[List[Op]], str, int]:
    """Per-DEVICE preferred op order. Returns (orders, placement, n_vstages)."""
    if name == "gpipe":
        orders = [
            [Op(s, m, F) for m in range(M)] + [Op(s, m, B) for m in range(M)]
            for s in range(P)
        ]
        return orders, "plain", P
    if name in ("1f1b", "dapple", "pipedream", "pipedream_2bw", "varuna"):
        orders = []
        for s in range(P):
            warm = min(P - s, M)
            ops: List[Op] = [Op(s, m, F) for m in range(warm)]
            nf, nb = warm, 0
            while nb < M:
                ops.append(Op(s, nb, B))
                nb += 1
                if nf < M:
                    ops.append(Op(s, nf, F))
                    nf += 1
            orders.append(ops)
        return orders, "plain", P
    if name == "interleaved":
        # derive per-device orders from a virtual 1F1B execution on P*v
        # virtual devices (one per model chunk), then merge each real
        # device's chunk streams by virtual start time
        V = P * v
        times = _virtual_1f1b_times(V, M)
        orders = [[] for _ in range(P)]
        for d in range(P):
            ops = [
                (times[(vs, m, k)], Op(vs, m, k))
                for vs in range(d, V, P)
                for m in range(M)
                for k in (F, B)
            ]
            ops.sort(key=lambda x: (x[0], x[1].kind == F, x[1].stage))
            orders[d] = [o for _, o in ops]
        return orders, "interleaved", V
    if name in ("chimera", "gems"):
        # bidirectional: 2 virtual pipelines; each device hosts vstage s and
        # vstage P + (P-1-s). Chimera splits microbatches between directions.
        V = 2 * P
        half = M // 2 if name == "chimera" else M
        orders = [[] for _ in range(P)]
        for dev in range(P):
            up, down = dev, 2 * P - 1 - dev  # wait: see _device_of mapping
            down = P + (P - 1 - dev)
            ops: List[Op] = []
            mbs_up = range(0, half)
            mbs_down = range(half, M) if name == "chimera" else range(0)
            for m_u, m_d in zip(list(mbs_up) + [None] * M, list(mbs_down) + [None] * M):
                if m_u is not None:
                    ops.append(Op(up, m_u, F))
                if m_d is not None:
                    ops.append(Op(down, m_d, F))
            for m_u, m_d in zip(list(mbs_up) + [None] * M, list(mbs_down) + [None] * M):
                if m_u is not None:
                    ops.append(Op(up, m_u, B))
                if m_d is not None:
                    ops.append(Op(down, m_d, B))
            orders[dev] = [o for o in ops if o.mb is not None]
        return orders, "bidirectional", 2 * P
    raise ValueError(f"unknown schedule {name!r}")


def _virtual_1f1b_times(V: int, M: int, tf: float = 1.0, tb: float = 2.0):
    """Start time of every (vstage, mb, kind) under 1F1B with V devices."""
    orders, _, _ = _op_order("1f1b", V, M, 1)
    ready_f = np.full((V, M), np.inf)
    ready_b = np.full((V, M), np.inf)
    ready_f[0, :] = 0.0
    done_f = np.full((V, M), np.inf)
    dev_time = np.zeros(V)
    queues = [list(o) for o in orders]
    times: Dict[Tuple[int, int, str], float] = {}
    remaining = sum(len(q) for q in queues)
    while remaining:
        for d in range(V):
            if not queues[d]:
                continue
            for qi, op in enumerate(queues[d]):
                if op.kind == F:
                    t_in, dur = ready_f[op.stage, op.mb], tf
                else:
                    t_in = (
                        done_f[op.stage, op.mb]
                        if op.stage == V - 1
                        else max(done_f[op.stage, op.mb], ready_b[op.stage, op.mb])
                    )
                    dur = tb
                if not np.isfinite(t_in):
                    continue
                start = max(dev_time[d], t_in)
                end = start + dur
                dev_time[d] = end
                times[(op.stage, op.mb, op.kind)] = start
                if op.kind == F:
                    done_f[op.stage, op.mb] = end
                    if op.stage + 1 < V:
                        ready_f[op.stage + 1, op.mb] = end
                    else:
                        ready_b[op.stage, op.mb] = end
                else:
                    if op.stage > 0:
                        ready_b[op.stage - 1, op.mb] = end
                queues[d].pop(qi)
                remaining -= 1
                break
    return times


def _execute_schedule(
    name: str,
    P: int,
    M: int,
    *,
    v: int = 2,
    t_fwd: float = 1.0,
    t_bwd: float = 2.0,
    t_comm: float = 0.0,
):
    """Run the event-driven scheduler; returns (executed, dev_time, placement,
    V, chunks, t_fwd, t_bwd) where ``executed[d]`` is the per-device list of
    (start, end, Op). Shared engine behind ``simulate`` and ``tick_table``."""
    orders, placement, V = _op_order(name, P, M, v)
    chunks = V // P if placement != "plain" else 1
    if placement == "interleaved":
        # v chunks per device, each 1/v of the model: per-op time scales down
        t_fwd, t_bwd = t_fwd / chunks, t_bwd / chunks
    if placement == "bidirectional":
        # two half-depth pipelines: each vstage is half the per-device model
        t_fwd, t_bwd = t_fwd / 2, t_bwd / 2

    ready_f = np.full((V, M), np.inf)  # time input available
    ready_b = np.full((V, M), np.inf)
    for m in range(M):
        ready_f[0, m] = 0.0
        if placement == "bidirectional":
            ready_f[P, m] = 0.0        # reverse pipeline entry
    done_f = np.full((V, M), np.inf)
    done_b = np.full((V, M), np.inf)

    dev_time = np.zeros(P)
    queues = [list(o) for o in orders]
    executed = [[] for _ in range(P)]  # (start, end, op)

    total_ops = sum(len(q) for q in queues)
    n_exec = 0
    stall_guard = 0
    while n_exec < total_ops:
        progressed = False
        for d in range(P):
            if not queues[d]:
                continue
            # execute the first READY op in the device's preferred order
            # (greedy relaxation — exact for gpipe/1f1b whose orders are
            # dependency-consistent; documented approximation otherwise)
            pick = None
            for qi, op in enumerate(queues[d]):
                if op.kind == F:
                    t_in = ready_f[op.stage, op.mb]
                    dur = t_fwd
                else:
                    t_in = (
                        done_f[op.stage, op.mb]
                        if _is_last(op.stage, V, placement, P)
                        else max(done_f[op.stage, op.mb], ready_b[op.stage, op.mb])
                    )
                    dur = t_bwd
                if np.isfinite(t_in):
                    pick = (qi, op, t_in, dur)
                    break
            if pick is None:
                continue
            qi, op, t_in, dur = pick
            start = max(dev_time[d], t_in)
            end = start + dur
            dev_time[d] = end
            executed[d].append((start, end, op))
            if op.kind == F:
                done_f[op.stage, op.mb] = end
                nxt = _next_stage(op.stage, V, placement, P)
                if nxt is not None:
                    ready_f[nxt, op.mb] = end + t_comm
                else:
                    ready_b[op.stage, op.mb] = end  # loss -> own bwd
            else:
                done_b[op.stage, op.mb] = end
                prv = _prev_stage(op.stage, V, placement, P)
                if prv is not None:
                    ready_b[prv, op.mb] = end + t_comm
            queues[d].pop(qi)
            n_exec += 1
            progressed = True
        if not progressed:
            stall_guard += 1
            if stall_guard > total_ops * 4:
                raise RuntimeError(f"schedule {name} deadlocked")
        else:
            stall_guard = 0

    return executed, dev_time, placement, V, chunks, t_fwd, t_bwd


def simulate(
    name: str,
    P: int,
    M: int,
    *,
    v: int = 2,
    t_fwd: float = 1.0,
    t_bwd: float = 2.0,
    t_comm: float = 0.0,
) -> SimResult:
    """Event-driven simulation of a pipeline schedule."""
    asynchronous = name in ("pipedream", "pipedream_2bw", "varuna")
    executed, dev_time, placement, V, chunks, t_fwd, t_bwd = _execute_schedule(
        name, P, M, v=v, t_fwd=t_fwd, t_bwd=t_bwd, t_comm=t_comm
    )

    makespan = float(dev_time.max())
    work = M * (t_fwd + t_bwd) * chunks
    if placement == "bidirectional" and name == "chimera":
        work = M * (t_fwd + t_bwd)  # each direction carries M/2 microbatches
    bubble = 1.0 - work / makespan if makespan > 0 else 0.0

    # peak in-flight activations per device: fwd done, bwd not yet done
    peak = 0
    for d in range(P):
        events = []
        for (s0, e0, op) in executed[d]:
            if op.kind == F:
                events.append((e0, +1))
            else:
                events.append((e0, -1))
        cur = 0
        for _, delta in sorted(events):
            cur += delta
            peak = max(peak, cur)

    versions = {"pipedream": P, "pipedream_2bw": 2}.get(name, 1)
    staleness = {"pipedream": P - 1, "pipedream_2bw": 1}.get(name, 0)
    return SimResult(
        name=name,
        makespan=makespan,
        bubble_fraction=max(bubble, 0.0),
        peak_activations=peak,
        weight_versions=versions,
        synchronous=not asynchronous,
        max_staleness=staleness,
    )


def _is_last(vs: int, V: int, placement: str, P: int) -> bool:
    if placement == "bidirectional":
        return vs == P - 1 or vs == 2 * P - 1
    return vs == V - 1


def _next_stage(vs: int, V: int, placement: str, P: int) -> Optional[int]:
    if placement == "bidirectional":
        if vs == P - 1 or vs == 2 * P - 1:
            return None
        return vs + 1
    return vs + 1 if vs + 1 < V else None


def _prev_stage(vs: int, V: int, placement: str, P: int) -> Optional[int]:
    if placement == "bidirectional":
        if vs == 0 or vs == P:
            return None
        return vs - 1
    return vs - 1 if vs > 0 else None


SCHEDULES = (
    "gpipe", "1f1b", "interleaved", "pipedream", "pipedream_2bw",
    "chimera", "gems",
)



# =====================================================================
# Part 2: the mesh runners (not ported yet)
# =====================================================================
def pipeline_apply(*args, **kwargs):
    """GPipe by autodiff across a ``pipe`` mesh axis in JAX."""
    raise NotImplementedError(f"pipeline_apply: {MESH_RUNNERS}")


def pipeline_grads(*args, **kwargs):
    """The manual-backward runner inside ``shard_map`` across P devices in
    JAX; on one device, :func:`pipeline_grads_host` runs the same tables."""
    raise NotImplementedError(f"pipeline_grads: {MESH_RUNNERS}")


# =====================================================================
# Part 3: tick tables + manual-backward runner (1F1B and GPipe)
# =====================================================================
EXECUTABLE_SCHEDULES = ("gpipe", "1f1b")


@dataclasses.dataclass(frozen=True)
class TickTable:
    """Integer-tick execution tables compiled from the event simulator.

    The simulator is run at unit op cost (t_fwd = t_bwd = 1, t_comm = 0), so
    op start times are a global integer tick clock on which every device
    executes at most one op per tick and a value ppermuted at the end of
    tick ``t`` is available at tick ``t + 1``. Tables are (n_ticks, P)
    int32, entry -1 = nothing this tick:

      f_mb / b_mb    microbatch to forward / backward
      f_slot         activation-buffer slot holding (or to hold) the stage
                     INPUT of that microbatch
      b_slot         activation slot to read for the backward (same slot
                     its forward stored; freed afterwards)
      b_cot          cotangent slot carrying the arriving upstream gradient
                     (-1 on the last stage, which seeds from the loss)
      arr_f / arr_b  slot into which this tick's arriving ppermute traffic
                     (activation / cotangent) must be stored

    ``n_act_slots`` is the greedy-allocated per-device activation buffer
    depth — the executable form of Table 4's "peak in-flight activations":
    O(M) for GPipe, O(P) for 1F1B. ``bubble_fraction`` is exact for the
    executable schedule (each device computes 2M of n_ticks op slots) and
    must agree with ``simulate(name, P, M, t_fwd=1, t_bwd=1)`` — the bench
    asserts this simulator-vs-executable accounting row.
    """
    schedule: str
    n_stages: int
    n_microbatches: int
    n_ticks: int
    n_act_slots: int
    n_cot_slots: int
    f_mb: np.ndarray
    f_slot: np.ndarray
    b_mb: np.ndarray
    b_slot: np.ndarray
    b_cot: np.ndarray
    arr_f: np.ndarray
    arr_b: np.ndarray

    @property
    def bubble_fraction(self) -> float:
        return 1.0 - 2.0 * self.n_microbatches / self.n_ticks

    def peak_activation_bytes(self, act_bytes: int) -> int:
        """Live pipeline-state bytes per device for one microbatch size."""
        return (self.n_act_slots + self.n_cot_slots) * act_bytes


def _alloc_slots(avail: Dict, last_use: Dict) -> Tuple[Dict, int]:
    """Greedy per-stage interval slot allocation: a slot is live from its
    value's arrival tick through its last-use tick (inclusive; arrivals at a
    tick are stored before that tick's op reads, so reuse needs end < start)."""
    slots: Dict = {}
    depth = 0
    by_stage: Dict[int, List] = {}
    for key in avail:
        by_stage.setdefault(key[0], []).append(key)
    for s, keys in by_stage.items():
        keys.sort(key=lambda k: (avail[k], k[1]))
        busy: List[Tuple[int, int]] = []   # (last_use, slot)
        free: List[int] = []
        used = 0
        for k in keys:
            t0 = avail[k]
            free += [sl for end, sl in busy if end < t0]
            busy = [(end, sl) for end, sl in busy if end >= t0]
            free.sort()
            if free:
                sl = free.pop(0)
            else:
                sl = used
                used += 1
            slots[k] = sl
            busy.append((last_use[k], sl))
        depth = max(depth, used)
    return slots, depth


def tick_table(schedule: str, P: int, M: int) -> TickTable:
    """Compile ``schedule`` into integer tick tables (see TickTable)."""
    if schedule not in EXECUTABLE_SCHEDULES:
        raise ValueError(
            f"executable schedules are {EXECUTABLE_SCHEDULES}, got {schedule!r}"
        )
    executed, _, _, _, _, _, _ = _execute_schedule(
        schedule, P, M, v=1, t_fwd=1.0, t_bwd=1.0, t_comm=0.0
    )
    f_tick: Dict[Tuple[int, int], int] = {}
    b_tick: Dict[Tuple[int, int], int] = {}
    for evs in executed:
        for (s0, e0, op) in evs:
            t = int(round(s0))
            assert abs(s0 - t) < 1e-9 and abs(e0 - t - 1) < 1e-9, (s0, e0, op)
            (f_tick if op.kind == F else b_tick)[(op.stage, op.mb)] = t
    T = 1 + max(b_tick.values())

    # availability: when the stage input / upstream cotangent lands locally
    avail_f = {
        (s, m): (t if s == 0 else f_tick[(s - 1, m)] + 1)
        for (s, m), t in f_tick.items()
    }
    avail_b = {
        (s, m): b_tick[(s + 1, m)] + 1 for (s, m) in b_tick if s < P - 1
    }
    for k, t in f_tick.items():
        assert avail_f[k] <= t, ("fwd before input available", k)
        if k in avail_b:
            assert avail_b[k] <= b_tick[k], ("bwd before cotangent", k)

    act_slot, n_act = _alloc_slots(avail_f, b_tick)
    cot_slot, n_cot = _alloc_slots(avail_b, {k: b_tick[k] for k in avail_b})
    n_cot = max(n_cot, 1)

    tables = {
        name: np.full((T, P), -1, np.int32)
        for name in ("f_mb", "f_slot", "b_mb", "b_slot", "b_cot",
                     "arr_f", "arr_b")
    }
    for (s, m), t in f_tick.items():
        tables["f_mb"][t, s] = m
        tables["f_slot"][t, s] = act_slot[(s, m)]
        if s > 0:
            ta = avail_f[(s, m)]
            assert tables["arr_f"][ta, s] == -1, "two fwd arrivals in one tick"
            tables["arr_f"][ta, s] = act_slot[(s, m)]
    for (s, m), t in b_tick.items():
        tables["b_mb"][t, s] = m
        tables["b_slot"][t, s] = act_slot[(s, m)]
        if s < P - 1:
            tables["b_cot"][t, s] = cot_slot[(s, m)]
            ta = avail_b[(s, m)]
            assert tables["arr_b"][ta, s] == -1, "two bwd arrivals in one tick"
            tables["arr_b"][ta, s] = cot_slot[(s, m)]
    return TickTable(
        schedule=schedule, n_stages=P, n_microbatches=M, n_ticks=T,
        n_act_slots=n_act, n_cot_slots=n_cot, **tables,
    )



def parameters_of(obj: Any) -> List[torch.Tensor]:
    """The parameter tensors of a module, a tensor, or a dict / list / tuple
    of them (None is empty), in order."""
    if obj is None:
        return []
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, nn.Module):
        return list(obj.parameters())
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in parameters_of(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in parameters_of(v)]
    raise TypeError(f"no parameters in a {type(obj).__name__}")


def _index(tree: Any, m: int) -> Any:
    """Microbatch ``m`` of a tensor or a dict of tensors with a leading M."""
    if isinstance(tree, dict):
        return {k: v[m] for k, v in tree.items()}
    return tree[m]


def pipeline_grads_host(
    first_fn: Callable,
    stage_fn: Callable,
    last_fn: Callable,
    stage_params: Sequence[Any],
    shared_params: Any,
    microbatches: Any,
    *,
    table: TickTable,
    x_struct: SlotSpec,
    metrics_struct: Sequence[str],
    seed: Optional[torch.Tensor] = None,
    stash=None,
    lookahead: int = 2,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
    """Run one pipelined forward and backward on one device; returns
    (loss_sum, metric sums, stage grads, shared grads).

    Callables, per microbatch:
      first_fn(shared, mb)   -> x            stage 0's input (the embedding)
      stage_fn(layers, x)    -> (y, aux)     a stage's layers; ``aux`` a
                                             scalar loss term, seeded on
                                             every stage
      last_fn(shared, y, mb) -> (loss, metrics)   head and loss, last stage

    ``stage_params`` holds the L layers (modules or tensors), stage s takes
    ``stage_params[s*L/P:(s+1)*L/P]``; ``shared_params`` the embedding, head
    and final norm (a module, a tensor or a dict of them). Every parameter
    must require grad. ``microbatches`` is a tensor or a dict of tensors with
    a leading M. ``x_struct`` is the inter-stage activation's SlotSpec;
    ``seed`` the loss cotangent (loss scale over M); ``metrics_struct`` the
    names of ``last_fn``'s metrics. The grads are f32 and aligned with
    ``parameters_of(stage_params)`` and ``parameters_of(shared_params)``; a
    parameter a stage does not use (the head before the last stage) adds
    nothing.

    ``stash`` (core.stash) stores the activation slots: RawStash by default.
    Every stage's forward consumes the slot's stored value — stage 0 puts its
    embedding and reads it back, and its backward recomputes the embedding
    through ``stash.roundtrip`` — so the grads are those of the forward that
    ran. A backend with ``cotangents`` also passes each arriving cotangent
    through ``roundtrip``. Each tick first ``poll``s every stage's store, then
    ``prefetch``es the slots of the next ``lookahead`` ticks' backward ops
    (HostStash's overlap; no-ops for the others). Prefetching only moves
    residency, so the result is bitwise the same for every lookahead.
    """
    backend = stash if stash is not None else RawStash()
    quant_cot = bool(getattr(backend, "cotangents", False))
    P, M = table.n_stages, table.n_microbatches
    L = len(stage_params)
    assert L % P == 0, (L, P)
    k = L // P
    Wa, Wc = table.n_act_slots, table.n_cot_slots
    dev = x_struct.device
    layers = [list(stage_params[s * k:(s + 1) * k]) for s in range(P)]
    stage_leaves = [parameters_of(ls) for ls in layers]
    shared_leaves = parameters_of(shared_params)
    if seed is None:
        seed = torch.ones((), dtype=torch.float32, device=dev)

    def f32_zeros(ts):
        return [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in ts]

    acts = [backend.init(Wa, x_struct) for _ in range(P)]
    cots: List[List[Any]] = [[None] * max(Wc, 1) for _ in range(P)]
    gacc = [f32_zeros(ls) for ls in stage_leaves]
    sacc = f32_zeros(shared_leaves)
    lacc = torch.zeros((), dtype=torch.float32, device=dev)
    macc = {name: torch.zeros((), dtype=torch.float32, device=dev)
            for name in metrics_struct}
    fwd_wire: List[Any] = [None] * P
    bwd_wire: List[Any] = [None] * P

    def forward_op(s: int, m: int, slot: int) -> torch.Tensor:
        """Stage s on microbatch m from its slot, recording no graph."""
        with torch.no_grad():
            if s == 0:
                x0 = first_fn(shared_params, _index(microbatches, m))
                acts[0] = backend.put(acts[0], slot, x0.to(x_struct.dtype))
            return stage_fn(layers[s], backend.get(acts[s], slot, x_struct))[0]

    def backward_op(s: int, m: int, slot: int, cot: int) -> Optional[torch.Tensor]:
        """Recompute stage s on microbatch m from its slot, pull (the
        cotangent in cot slot ``cot``, seed) back, and add the grads into
        the accumulators. Returns the input's cotangent (None on stage 0).
        The op's grads die on return: held to the next op, they would sit
        beside its own (a stage's parameters in f32)."""
        nonlocal lacc
        x_saved = backend.get(acts[s], slot, x_struct)
        y_cot = cots[s][cot] if s < P - 1 else None
        mb = _index(microbatches, m)
        with torch.enable_grad():
            x_leaf = None
            if s == 0:
                x = backend.roundtrip(first_fn(shared_params, mb).to(x_struct.dtype))
            else:
                x = x_leaf = x_saved.detach().requires_grad_(True)
            y, aux = stage_fn(layers[s], x)
            loss = aux.float()
            metrics = {}
            if s == P - 1:
                tail, metrics = last_fn(shared_params, y, mb)
                loss = loss + tail
            outs, outs_cot = [], []
            if s < P - 1:
                outs.append(y)
                outs_cot.append(y_cot)
            if loss.requires_grad:
                outs.append(loss)
                outs_cot.append(seed)
            inputs = stage_leaves[s] + shared_leaves + ([x_leaf] if x_leaf is not None else [])
            grads = torch.autograd.grad(outs, inputs, outs_cot, allow_unused=True)
        n_sp = len(stage_leaves[s])
        with torch.no_grad():
            for g, d in zip(gacc[s] + sacc, grads[:n_sp + len(shared_leaves)]):
                if d is not None:
                    g.add_(d)
            for name, v in metrics.items():
                macc[name] += v.detach()
            lacc += loss.detach()
        return grads[-1] if x_leaf is not None else None

    for t in range(table.n_ticks):
        # arrivals land before this tick's ops read the buffers
        for s in range(P):
            af = int(table.arr_f[t, s])
            if af >= 0:
                acts[s] = backend.put(acts[s], af, fwd_wire[s])
                fwd_wire[s] = None
            ab = int(table.arr_b[t, s])
            if ab >= 0:
                with torch.no_grad():
                    cots[s][ab] = backend.roundtrip(bwd_wire[s]) if quant_cot else bwd_wire[s]
                bwd_wire[s] = None
        # overlap pass: retire landed evictions, then start the loads of the
        # next ticks' backward slots
        for s in range(P):
            backend.poll(acts[s])
        for dt in range(1, lookahead + 1):
            if t + dt >= table.n_ticks:
                break
            for s in range(P):
                if int(table.b_mb[t + dt, s]) >= 0:
                    backend.prefetch(acts[s], int(table.b_slot[t + dt, s]))
        next_fwd: List[Any] = [None] * P
        next_bwd: List[Any] = [None] * P
        for s in range(P):
            fm, bm = int(table.f_mb[t, s]), int(table.b_mb[t, s])
            if fm >= 0:
                y = forward_op(s, fm, int(table.f_slot[t, s]))
                if s + 1 < P:
                    next_fwd[s + 1] = y
                del y
            elif bm >= 0:
                dx = backward_op(s, bm, int(table.b_slot[t, s]), int(table.b_cot[t, s]))
                if s > 0:
                    next_bwd[s - 1] = dx
                del dx
        fwd_wire, bwd_wire = next_fwd, next_bwd
    return lacc, macc, [g for gs in gacc for g in gs], sacc
