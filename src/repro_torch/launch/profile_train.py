"""Where the training time goes on the card: gemma3-1b, the chip smoke's
training workload, under ``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile_train [--out DIR]

Runs ``workload.gemma_train_workload()`` (the workload of ``chip_smoke.py``'s
train phase): two warm-up steps, three timed steps without the profiler,
then three steps under it. Prints one JSON line: the card, the median step
time, tokens/s and peak memory of the unprofiled steps, and for the
profiled window its wall time, device-busy time, idle share and the device
time of each kernel family — K1 to K4 by kernel, the matmuls, the rest. The
full operator table goes to ``DIR``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

FAMILIES = (
    ("fa_fwd_kernel", "K1 flash_attention_fwd"),
    ("fa_bwd_delta", "K2 flash_attention_bwd_delta"),
    ("fa_bwd_dq", "K2 flash_attention_bwd_dq"),
    ("fa_bwd_dkv", "K2 flash_attention_bwd_dkv"),
    ("rmsnorm_fwd", "K3 rmsnorm_fwd"),
    ("rmsnorm_bwd", "K4 rmsnorm_bwd"),
    ("rmsnorm_dscale", "K4 rmsnorm_bwd"),
)


def _self_device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _family(name: str) -> str:
    for key, fam in FAMILIES:
        if key in name:
            return fam
    low = name.lower()
    if any(k in low for k in ("gemm", "gemv", "nvjet", "cutlass", "splitkreduce")):
        return "matmul (cuBLAS)"
    return "other elementwise/reduction/copy"


def _steps(step_fn, state, data, n, dev):
    """n steps; returns (state, per-step wall seconds), each step ending in a
    device synchronisation."""
    times = []
    for _ in range(n):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in next(data).items()}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return state, times


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="profile_train_out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train measures the card; CUDA is not available")

    from repro_torch.launch.workload import gemma_train_workload
    from repro_torch.optim import get as get_opt
    from repro_torch.train import make_state, make_train_step

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    wl = gemma_train_workload()
    opt = get_opt(wl.tc.optimizer, wl.tc.lr)
    state = make_state(wl.cfg, opt, wl.tc, seed=wl.seed, device="cuda")
    step_fn = make_train_step(wl.cfg, opt, wl.tc)
    data = wl.data()
    try:
        state, _ = _steps(step_fn, state, data, 2, "cuda")            # warm-up
        torch.cuda.reset_peak_memory_stats()
        state, times = _steps(step_fn, state, data, 3, "cuda")
        peak = torch.cuda.max_memory_allocated() / 1e9
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = _steps(step_fn, state, data, 3, "cuda")
            wall_s = time.perf_counter() - t0
    finally:
        data.close()
    families: dict = {}
    busy_us = 0.0
    averages = prof.key_averages()
    for evt in averages:
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = _self_device_us(evt)
        busy_us += us
        fam = families.setdefault(_family(evt.key), {"ms": 0.0, "calls": 0})
        fam["ms"] += us / 1e3
        fam["calls"] += evt.count
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "key_averages.txt").write_text(averages.table(
        sort_by="self_cuda_time_total", row_limit=60))
    step_s = statistics.median(times)
    print(json.dumps({
        "card": card, "config": wl.cfg.name, "batch": wl.batch, "seq": wl.seq,
        "step_ms": step_s * 1e3, "tokens_per_s": wl.tokens_per_step / step_s,
        "peak_mem_gb": peak, "profiled_steps": 3, "wall_s": wall_s,
        "device_busy_s": busy_us / 1e6, "idle_share": 1 - busy_us / 1e6 / wall_s,
        "families": families,
    }), flush=True)


if __name__ == "__main__":
    main()
