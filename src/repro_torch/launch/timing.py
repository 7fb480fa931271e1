"""Timing a kernel on the card, and the least time the card could take.

``time_ms`` gives the CUDA-event median of a function with the L2 flushed
before each call; ``bound`` the larger of its bytes over the memory rate and
its operations over the peak rate of their type (H100 SXM). ``chip_smoke.py``
and the ``profile_*`` scripts time every kernel with them.
"""
from __future__ import annotations

import statistics
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12         # H100 SXM HBM3
BF16_FLOPS = 989e12               # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12                 # H100 SXM float32 outside the tensor cores
SPIN_CYCLES = 2_000_000           # ~1 ms of the card's clock


def spin_ms(cycles: int) -> float:
    """CUDA-event time of one spin kernel of ``cycles`` alone."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    torch.cuda._sleep(cycles)
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def time_ms(fn, flush, warmup=5, reps=30, read_flush=False) -> float:
    """Median of ``reps`` CUDA-event timings, the L2 flushed before each by
    writing the card buffer ``flush`` (``read_flush``: by reading it, which
    leaves no dirty lines for the timed call's misses to write back). A
    spin kernel keeps the card busy while the host enqueues the first event
    and ``fn``'s launches, so that the time between the events is the card's
    alone: an idle card would wait for the host's launch latency between
    them (tens of µs, the whole time of a small kernel). The spin is checked
    to outlast every enqueue (host time from the first event's record to the
    second's), and lengthened fourfold until it does. A ``fn`` that waits on
    the card inside (its enqueue grows with the spin) cannot be covered so:
    its time keeps the host's part after the wait, as it does in use."""
    for _ in range(warmup):
        fn()
    cycles, before = SPIN_CYCLES, None
    while True:
        spin = spin_ms(cycles)
        times, enqueue = [], []
        for _ in range(reps):
            flush.sum() if read_flush else flush.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            t0 = time.perf_counter()
            a.record()
            fn()
            b.record()
            enqueue.append((time.perf_counter() - t0) * 1e3)
            b.synchronize()
            times.append(a.elapsed_time(b))
        took = max(enqueue)
        if took < spin:
            return statistics.median(times)
        if before is not None and took - before[0] > (spin - before[1]) / 2:
            print(f"time_ms: the enqueue grows with the spin ({before[0]:.3f} ms at a "
                  f"{before[1]:.3f} ms spin, {took:.3f} at {spin:.3f}): the function "
                  "waits on the card", file=sys.stderr)
            return statistics.median(times)
        if cycles >= 64 * SPIN_CYCLES:
            raise AssertionError(f"time_ms: an enqueue took {took:.3f} ms, "
                                 f"longer than a {spin:.3f} ms spin")
        print(f"time_ms: an enqueue took {took:.3f} ms, longer than a "
              f"{spin:.3f} ms spin: spinning 4x longer", file=sys.stderr)
        cycles, before = cycles * 4, (took, spin)


def bound(nbytes, flops, dtype):
    """(ms, "bytes" or "operations"): the least time for ``nbytes`` moved and
    ``flops`` done on values of ``dtype``, and which of the two sets it."""
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")
