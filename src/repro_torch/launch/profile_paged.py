"""Where K5's and K6's time goes on the card: each CUDA kernel of the two ops
(split kernels, combines) at the serving shapes of ``chip_smoke.py``'s
kernels phase, under ``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile_paged [--reps 20] \
        [--kv-dtype bf16|int8|fp8]

For each shape: ``reps`` calls of the op, each after a 64 MB write that
flushes the L2 (as ``chip_smoke.py`` times them), and one JSON line with the
mean device time per call of every kernel the op launched, their sum, the
median span of one call on the card (first kernel's start to last one's
end), and the CUDA-event times of 0, 1, 2 and 8 calls queued behind a spin
kernel (L2 warm). ``--kv-dtype int8|fp8`` quantizes the same pools with
``quant.kv_quantize`` and times the quantized kernels (q stays bf16).
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

# (model, kind, shape): chip_smoke.py's bf16 serving shapes
SHAPES = [
    ("granite-8b", "decode", dict(B=4, Kv=8, G=4, hd=128, page=16, P=40,
                                  lengths=[561, 590, 600, 633], window=0)),
    ("granite-8b", "prefill", dict(B=1, T=128, Kv=8, G=4, hd=128, page=16, P=40,
                                   starts=[384], qlens=[128], window=0)),
    ("granite-8b", "prefill", dict(B=1, T=128, Kv=8, G=4, hd=128, page=16, P=40,
                                   starts=[256], qlens=[77], window=0)),
    ("gemma3-1b", "decode", dict(B=4, Kv=1, G=4, hd=256, page=16, P=90,
                                 lengths=[1030, 1100, 1250, 1400], window=512)),
    ("gemma3-1b", "prefill", dict(B=1, T=128, Kv=1, G=4, hd=256, page=16, P=90,
                                  starts=[1000], qlens=[128], window=512)),
]


def make_args(kind, s, dtype=torch.bfloat16, seed=0, kv_dtype="bf16"):
    """Random pools and disjoint tables on the card for one shape, and the
    op's scale operands (none for a bf16 pool)."""
    rng = np.random.RandomState(seed)
    B, Kv, G, hd, page, P = s["B"], s["Kv"], s["G"], s["hd"], s["page"], s["P"]
    ends = s["lengths"] if kind == "decode" else [st + s["T"] for st in s["starts"]]
    N = 1 + sum(-(-e // page) for e in ends)
    qshape = (B, Kv, G, hd) if kind == "decode" else (B, s["T"], Kv, G, hd)
    t = lambda *shape: torch.tensor(rng.randn(*shape), dtype=dtype, device="cuda")  # noqa: E731
    q = t(*qshape) * hd ** -0.5
    kp, vp = t(N, page, Kv, hd), t(N, page, Kv, hd)
    tables = np.zeros((B, P), np.int32)
    nxt = 1
    for b, e in enumerate(ends):
        n = -(-e // page)
        tables[b, :n] = np.arange(nxt, nxt + n)
        nxt += n
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device="cuda")  # noqa: E731
    ints = [i32(s["lengths"])] if kind == "decode" else [i32(s["starts"]), i32(s["qlens"])]
    scales = {}
    if kv_dtype != "bf16":
        from repro_torch.kernels.paged_attention import quant

        store = quant.kv_storage_dtype(kv_dtype, dtype)
        (kp, ks), (vp, vs) = quant.kv_quantize(kp, store), quant.kv_quantize(vp, store)
        scales = dict(k_scale=ks, v_scale=vs)
    return [q.contiguous(), kp, vp, i32(tables)] + ints, scales


def busy_call_ms(fn, n: int) -> float:
    """CUDA-event time of ``n`` calls queued behind a 1 ms spin (L2 warm)."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--kv-dtype", default="bf16", choices=("bf16", "int8", "fp8"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_paged measures the card; CUDA is not available")
    from repro_torch.kernels.paged_attention import cuda

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    for model, kind, s in SHAPES:
        a, sc = make_args(kind, s, kv_dtype=args.kv_dtype)
        op = cuda.paged_decode_attention_cuda if kind == "decode" else \
            cuda.paged_prefill_attention_cuda
        fn = lambda: op(*a, window=s["window"], **sc)  # noqa: E731
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        kernels = {}
        for evt in prof.key_averages():
            name = re.search(r"paged_\w+_kernel", evt.key)
            if name is None:
                continue
            us = getattr(evt, "self_device_time_total", 0) or getattr(
                evt, "self_cuda_time_total", 0)
            kernels[name.group()] = dict(ms_per_call=us / 1e3 / args.reps,
                                         launches=evt.count)
        # one call's span on the card: first kernel's start to last one's end
        spans = []
        evts = sorted((e for e in prof.events() if re.search(r"paged_\w+_kernel", e.name)
                       and e.device_type == torch.autograd.DeviceType.CUDA),
                      key=lambda e: e.time_range.start)
        per = len(evts) // args.reps
        for i in range(0, per * args.reps, max(per, 1)):
            spans.append((evts[i + per - 1].time_range.end - evts[i].time_range.start) / 1e3)
        busy = {n: sorted(busy_call_ms(fn, n) for _ in range(11))[5] for n in (0, 1, 2, 8)}
        print(json.dumps(dict(card=card, kv_dtype=args.kv_dtype, model=model, kind=kind,
                              shape=s, kernels=kernels,
                              kernels_ms=sum(k["ms_per_call"] for k in kernels.values()),
                              span_ms=sorted(spans)[len(spans) // 2] if spans else None,
                              busy_calls_ms=busy)), flush=True)


if __name__ == "__main__":
    main()
