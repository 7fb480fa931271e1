"""K2's delta pass on the card, at the training paths' shapes, beside a
stream of the same bytes.

    PYTHONPATH=src python -m repro_torch.launch.profile_delta [--reps 30]

``SHAPES``: the flat (BH, S, hd) bf16 o and dO of gemma3-1b's train step
(batch 4 x seq 2048, 16 query heads of hd 256), granite-8b's (one sequence
of 2048, 32 query heads of hd 128: the pipe's microbatch) and
phi-3-vision's (32 heads of hd 96). For each it prints one JSON line: the
kernel's CUDA-event median (``timing.time_ms``) after an L2 flush that
writes 64 MB and after one that reads it, the same for ``copy_`` of o (the
same bytes read and written, less delta's 4 bytes a row) and for the plain
version, and the byte bound. No single PyTorch call computes delta in f32
(``torch.linalg.vecdot`` of bf16 returns bf16), so ``copy_`` is the
yardstick. It uses only the wrappers' public names, so a copy of it and of
``timing.py`` times an older tree's kernel the same way.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from repro_torch.launch.timing import bound, time_ms

# (model, BH, S, hd)
SHAPES = [("gemma3-1b", 16, 2048, 256), ("granite-8b", 32, 2048, 128),
          ("phi-3-vision-4.2b", 32, 2048, 96)]


def inputs(BH: int, S: int, hd: int):
    """o and dO (BH, S, hd) bf16 on the card, from numpy."""
    rng = np.random.RandomState(BH + S + hd)
    return [torch.tensor(rng.randn(BH, S, hd), dtype=torch.float32).to("cuda", torch.bfloat16)
            for _ in range(2)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_delta measures the card; CUDA is not available")
    from repro_torch.kernels.flash_attention import cuda, ref

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    for model, BH, S, hd in SHAPES:
        o, do = inputs(BH, S, hd)
        sink = torch.empty_like(o)
        fns = {"kernel": lambda: cuda.flash_attention_bwd_delta_cuda(o, do),
               "copy": lambda: sink.copy_(o),
               "plain": lambda: ref.flash_attention_bwd_delta_plain(o, do)}
        err = float((fns["kernel"]() - fns["plain"]()).abs().max())
        nbytes = 2 * o.numel() * 2 + BH * S * 4
        bms, by = bound(nbytes, 2 * o.numel(), torch.bfloat16)
        row = dict(card=card, model=model, shape=dict(BH=BH, S=S, hd=hd), bytes=nbytes,
                   bound_ms=bms, bound_by=by, max_abs_err=err)
        for name, fn in fns.items():
            row[f"{name}_ms"] = time_ms(fn, flush, reps=args.reps)
            row[f"{name}_ms_read_flush"] = time_ms(fn, flush, reps=args.reps,
                                                   read_flush=True)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
