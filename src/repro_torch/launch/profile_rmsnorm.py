"""Where K3's and K4's time goes on the card, at the main paths' shapes.

    PYTHONPATH=src python -m repro_torch.launch.profile_rmsnorm [--reps 30]

``SHAPES`` (bf16 x, f32 scale): the train phase's (8192, 1152) (gemma3-1b)
and (8192, 4096) (granite-8b), the pipe's (2048, 4096) microbatch, and K3
alone at serving's (4, 4096) decode and (128, 4096) prefill chunk.
``timed`` makes the inputs and, for each op, what is timed beside the kernel:
its plain version, ``F.rms_norm`` (its autograd backward for K4) and a
stream of the same bytes through one PyTorch elementwise kernel (``copy_``
for K3's read and write, ``add`` of x and g for K4's), with the op's bytes
and operations. ``chip_smoke.py`` holds the kernels against their plain
versions at these shapes and times kernel, plain and library there.

This script prints one JSON line per op and shape with what chip_smoke does
not measure: the kernel and the stream after an L2 flush that writes 64 MB
and after one that reads it (the write leaves dirty lines that the timed
call's misses write back), and under ``torch.profiler`` the mean device time
per call of every kernel the wrapper launched (K4's row kernel and its
dscale combine apart).
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch.timing import bound, time_ms

FWD, BWD = "rmsnorm_fwd", "rmsnorm_bwd"
# (what runs at the shape, rows, d, ops)
SHAPES = [
    ("gemma3-1b", 8192, 1152, (FWD, BWD)),          # train: batch 4 x seq 2048
    ("granite-8b", 8192, 4096, (FWD, BWD)),
    ("granite-8b pipe", 2048, 4096, (FWD, BWD)),     # the pipe's microbatch
    ("granite-8b decode", 4, 4096, (FWD,)),          # serving: 4 slots
    ("granite-8b prefill", 128, 4096, (FWD,)),       # serving: a 128-token chunk
]


class Timed(NamedTuple):
    kernel: Callable
    plain: Callable
    library: Callable
    stream: Callable
    nbytes: int
    flops: int


def timed(rows: int, d: int):
    """((x, scale, g), {op: Timed}) on the card: x and g (rows, d) bf16 and
    scale (d,) f32 from a seed. Bytes: x (and g) read and the output written
    once, scale read (and dscale written) once."""
    from repro_torch.kernels.rmsnorm import cuda, ref

    rng = np.random.RandomState(rows + d)
    x, g = (torch.tensor(rng.randn(rows, d), dtype=torch.float32)
            .to("cuda", torch.bfloat16) for _ in range(2))
    scale = torch.tensor(1 + 0.1 * rng.randn(d), dtype=torch.float32, device="cuda")
    w = scale.to(torch.bfloat16)
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    lib_out = F.rms_norm(xg, (d,), wg, eps=1e-6)
    io = rows * d * 2
    sink = torch.empty_like(x)
    return (x, scale, g), {
        FWD: Timed(lambda: cuda.rmsnorm_fwd_cuda(x, scale),
                   lambda: ref.rmsnorm_plain(x, scale),
                   lambda: F.rms_norm(x, (d,), w, eps=1e-6),
                   lambda: sink.copy_(x), 2 * io + 4 * d, 4 * rows * d),
        BWD: Timed(lambda: cuda.rmsnorm_bwd_cuda(x, scale, g),
                   lambda: ref.rmsnorm_bwd_plain(x, scale, g),
                   lambda: torch.autograd.grad(lib_out, (xg, wg), g, retain_graph=True),
                   lambda: torch.add(x, g, out=sink), 3 * io + 8 * d, 10 * rows * d),
    }


def kernel_split(fn, flush, reps: int) -> dict:
    """Mean device ms per call of each kernel whose name holds ``rmsnorm``."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        m = re.search(r"rmsnorm\w*", evt.key)
        if m is None:
            continue
        us = getattr(evt, "self_device_time_total", 0) or getattr(evt, "self_cuda_time_total", 0)
        out[m.group()] = dict(ms_per_call=us / 1e3 / reps, launches=evt.count)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_rmsnorm measures the card; CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")

    def ms(fn, read_flush=False):
        return time_ms(fn, flush, reps=args.reps, read_flush=read_flush)

    for model, rows, d, ops in SHAPES:
        _, spec = timed(rows, d)
        for op in ops:
            t = spec[op]
            bms, by = bound(t.nbytes, t.flops, torch.bfloat16)
            print(json.dumps(dict(
                card=card, op=op, model=model, rows=rows, d=d, dtype="bf16",
                kernel_ms=ms(t.kernel), kernel_ms_read_flush=ms(t.kernel, read_flush=True),
                stream_ms=ms(t.stream), stream_ms_read_flush=ms(t.stream, read_flush=True),
                plain_ms=ms(t.plain), library_ms=ms(t.library),
                bound_ms=bms, bound_by=by, bytes=t.nbytes, flops=t.flops,
                kernels=kernel_split(t.kernel, flush, args.reps))), flush=True)


if __name__ == "__main__":
    main()
