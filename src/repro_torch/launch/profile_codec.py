"""Where the blockwise codecs' time goes on the card, at the main paths' sizes.

    PYTHONPATH=src python -m repro_torch.launch.profile_codec [--reps 30]

K8a / K8b (the dynamic 8-bit codec of 8-bit Adam) run at every size of
``K8_LEAVES``, gemma3-1b's quantized leaves as ``ops.quantize`` pads them,
on three inputs (``k8_input``): ``m`` (normal values whose block magnitude
varies over four decades, like Adam's first moment), ``v`` (their squares:
non-negative, so the code search walks only the upper half of the map, like
the second moment) and ``adversarial`` (values spread evenly over the 256
codes). K7a / K7b (the stash's symmetric codec) run at the pipe's slot
``STASH_SLOT`` in bf16, with int8 and with fp8 codes. ``chip_smoke.py``
holds the kernels against their plain versions at these sizes and times
kernel and plain version there, on the ``m`` input.

This script prints one JSON line per kernel, input and size with what
chip_smoke does not measure: the kernel and a PyTorch stream of the same
bytes less the scales (``x.to(torch.uint8)`` from f32 for K8a, its reverse
for K8b, ``x.to(torch.int8)`` from bf16 for K7a, its reverse for K7b) after
an L2 flush that writes 64 MB and after one that reads it (the write
leaves dirty lines that the timed call's misses write back), the bound,
and under ``torch.profiler`` the mean device time per call of the kernel
alone. A last line per kernel and input gives K8's mean per launch over one
train8 step's mix of leaves. Only the wrappers' public names and
``launch/timing.py`` are used, so the script also times a parent tree's
kernels when it is copied there with ``timing.py``.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch.timing import bound, time_ms

# the adam8bit main path's quantized leaves of gemma3-1b, padded to 16,384
# values as ops.quantize pads them: (padded size, leaves of that size); each
# leaf's m and v go through K8b then K8a once per step
K8_LEAVES = [
    (301_989_888, 1),          # embed/table (262,144 x 1,152)
    (207_028_224, 3),          # ffn w_up, w_down, w_gate (26 x 1,152 x 6,912)
    (30_670_848, 2),           # mixer wq, wo (26 x 1,152 x 1,024)
    (7_667_712, 2),            # mixer wk, wv (26 x 1,152 x 256)
    (32_768, 2),               # norm1, norm2 scale (26 x 1,152 = 29,952)
]
K8_PER_STEP = 2 * sum(k for _, k in K8_LEAVES)     # (m, v) per quantized leaf
K8_INPUTS = ("m", "v", "adversarial")
# one microbatch (1 x 2048) of granite-8b's d_model 4096: the pipe's slot
STASH_SLOT = (1, 2048, 4096)
QUANT, DEQUANT = "blockwise_quantize", "blockwise_dequantize"
STASH_QUANT, STASH_DEQUANT = "stash_quantize", "stash_dequantize"


def k8_bounds(n: int):
    """(bytes, flops) of K8a and K8b over n values: each input read once,
    each output written once (4 B values, 1 B codes, 4 B per 256-block
    scale); K8a does |x|, a max, a division and 8 compares per value, K8b
    one multiply."""
    scales = 4 * (n // 256)
    return {QUANT: (5 * n + scales, 11 * n), DEQUANT: (5 * n + scales, n)}


def stash_bounds(n: int, in_size: int, out_size: int):
    """(bytes, flops) of K7a (values of in_size bytes -> 1-byte codes and a
    4-byte scale per 256) and K7b (codes and scales -> values of out_size
    bytes): each input read once, each output written once; K7a does |x|, a
    max, a division, two clamps and a rounding per value, K7b a conversion
    and a multiply."""
    scales = 4 * (n // 256)
    return {STASH_QUANT: (n * in_size + n + scales, 6 * n),
            STASH_DEQUANT: (n + scales + n * out_size, 2 * n)}


def k8_input(kind: str, n: int, gen: torch.Generator) -> torch.Tensor:
    """n f32 values on ``gen``'s device. ``m``: normal, scaled per
    256-value block by 10^-U(0, 4); ``v``: the square of such values;
    ``adversarial``: each block a planted 1.0 (its absmax) and 255 codes of
    the map drawn uniformly, times a power of two per block, so that
    ``x / absmax`` lands on every code equally often."""
    from repro_torch.kernels.blockwise_quant.ref import code_table

    nb = n // 256
    if kind in ("m", "v"):
        x = torch.randn(n, generator=gen, device=gen.device)
        x *= 10.0 ** (-4 * torch.rand(nb, generator=gen, device=gen.device)).repeat_interleave(256)
        return x * x if kind == "v" else x
    if kind != "adversarial":
        raise ValueError(f"input {kind!r} not in {K8_INPUTS}")
    codes, _ = code_table(gen.device)
    idx = torch.randint(0, 256, (nb, 256), generator=gen, device=gen.device)
    x = codes[idx]
    x[:, 0] = 1.0
    shift = torch.randint(-13, 1, (nb, 1), generator=gen, device=gen.device).float()
    return (x * torch.exp2(shift)).reshape(-1)


def stash_input() -> torch.Tensor:
    """The pipe slot's bf16 values, normal from a seed (chip_smoke's)."""
    return torch.tensor(np.random.RandomState(1).randn(*STASH_SLOT),
                        dtype=torch.float32, device="cuda").to(torch.bfloat16)


def kernel_ms(fn, flush, reps: int, pattern: str) -> dict:
    """Mean device ms per call of each kernel whose name matches
    ``pattern``, under ``torch.profiler``, the L2 flushed before each call."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if re.search(pattern, evt.key) is None:
            continue
        us = getattr(evt, "self_device_time_total", 0) or getattr(evt, "self_cuda_time_total", 0)
        out[evt.key[:80]] = dict(ms_per_call=us / 1e3 / reps, launches=evt.count)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_codec measures the card; CUDA is not available")
    from repro_torch.kernels.blockwise_quant import cuda

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")

    def line(name, fn, stream, nbytes, flops, pattern, **kw):
        bms, by = bound(nbytes, flops, torch.float32)
        row = dict(card=card, kernel=name, **kw,
                   kernel_ms=time_ms(fn, flush, reps=args.reps),
                   kernel_ms_read_flush=time_ms(fn, flush, reps=args.reps, read_flush=True),
                   stream_ms=time_ms(stream, flush, reps=args.reps),
                   stream_ms_read_flush=time_ms(stream, flush, reps=args.reps, read_flush=True),
                   bound_ms=bms, bound_by=by, bytes=nbytes, flops=flops,
                   device=kernel_ms(fn, flush, args.reps, pattern))
        print(json.dumps(row), flush=True)
        return row

    gen = torch.Generator(device="cuda").manual_seed(8)
    for kind in K8_INPUTS:
        rows = {QUANT: [], DEQUANT: []}
        for n, leaves in K8_LEAVES:
            x = k8_input(kind, n, gen)
            c, s = cuda.quantize_cuda(x)
            b = k8_bounds(n)
            rows[QUANT].append(line(
                QUANT, lambda: cuda.quantize_cuda(x), lambda: x.to(torch.uint8), *b[QUANT],
                r"(?<!stash_)(?<!de)quantize_kernel", input=kind, n=n, leaves=leaves))
            rows[DEQUANT].append(line(
                DEQUANT, lambda: cuda.dequantize_cuda(c, s), lambda: c.to(torch.float32),
                *b[DEQUANT], r"(?<!stash_)dequantize_kernel", input=kind, n=n, leaves=leaves))
            del x, c, s
            torch.cuda.empty_cache()
        total = sum(k for _, k in K8_LEAVES)
        for name, rs in rows.items():
            mean = {k: sum(r[k] * r["leaves"] for r in rs) / total
                    for k in ("kernel_ms", "kernel_ms_read_flush", "stream_ms",
                              "stream_ms_read_flush", "bound_ms")}
            print(json.dumps(dict(card=card, kernel=name, input=kind,
                                  mean_per_launch=mean)), flush=True)

    x = stash_input()
    n = x.numel()
    b = stash_bounds(n, 2, 2)
    for storage in ("int8", "fp8"):
        c, s = cuda.stash_quantize_cuda(x.view(-1), storage)
        line(STASH_QUANT, lambda: cuda.stash_quantize_cuda(x.view(-1), storage, c, s),
             lambda: x.to(torch.int8), *b[STASH_QUANT], r"stash_quantize_kernel",
             storage=storage, shape=STASH_SLOT, dtype="bf16")
        line(STASH_DEQUANT, lambda: cuda.stash_dequantize_cuda(c, s, torch.bfloat16),
             lambda: c.view(torch.int8).to(torch.bfloat16), *b[STASH_DEQUANT],
             r"stash_dequantize_kernel", storage=storage, shape=STASH_SLOT, dtype="bf16")


if __name__ == "__main__":
    main()
