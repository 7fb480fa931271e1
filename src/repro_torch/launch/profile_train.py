"""Where the training time goes on the card: a training workload of
``chip_smoke.py`` under ``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile_train [--out DIR] \
        [--optimizer adamw|adam8bit] [--workload gemma|pipe]

``--workload gemma`` (the default) runs ``workload.gemma_train_workload()``
(``chip_smoke.py``'s train phase; with ``--optimizer adam8bit``,
``gemma_train8_workload()``, its train8 phase); ``--workload pipe`` runs
``granite_pipe_workload()``, the pipe phase: granite-8b at full width, 8
layers, through the host-driven 1F1B runner with the int8 stash. Two
warm-up steps, three timed steps without the profiler, then three steps
under it. Prints one JSON line: the card, the optimizer and its state's
bytes, the median step time, tokens/s and peak memory of the unprofiled
steps, and for the profiled window its wall time, device-busy time, idle
share and the device time of each kernel family — K1 to K4, K7 and K8 by
kernel, the matmuls, the rest. The full operator table goes to ``DIR``.
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
    ("fa_fwd", "K1 flash_attention_fwd"),          # f32 and bf16 (tensor-core) kernels
    ("fa_bwd_delta", "K2 flash_attention_bwd_delta"),
    ("fa_bwd_dq", "K2 flash_attention_bwd_dq"),
    ("fa_bwd_dkv", "K2 flash_attention_bwd_dkv"),
    ("rmsnorm_fwd", "K3 rmsnorm_fwd"),
    ("rmsnorm_bwd", "K4 rmsnorm_bwd"),
    ("rmsnorm_dscale", "K4 rmsnorm_bwd"),
    ("stash_dequantize", "K7b stash_dequantize"),       # before the substrings
    ("stash_quantize", "K7a stash_quantize"),           # of K8's names
    ("dequantize_kernel", "K8b blockwise_dequantize"),   # before its substring
    ("quantize_kernel", "K8a blockwise_quantize"),
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
    ap.add_argument("--optimizer", default="adamw", choices=("adamw", "adam8bit"))
    ap.add_argument("--workload", default="gemma", choices=("gemma", "pipe"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train measures the card; CUDA is not available")

    from repro_torch.launch.train import build_train_pipeline_host, optimizer_state_bytes
    from repro_torch.launch.workload import (gemma_train8_workload, gemma_train_workload,
                                             granite_pipe_workload)
    from repro_torch.optim import get as get_opt
    from repro_torch.train import make_state, make_train_step

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    if args.workload == "pipe":
        wl = granite_pipe_workload()
    else:
        wl = {"adamw": gemma_train_workload, "adam8bit": gemma_train8_workload}[args.optimizer]()
    opt = get_opt(wl.tc.optimizer, wl.tc.lr)
    state = make_state(wl.cfg, opt, wl.tc, seed=wl.seed, device="cuda")
    opt_bytes, adamw_bytes = optimizer_state_bytes(state)
    if wl.plan is not None:
        step_fn, _ = build_train_pipeline_host(wl.cfg, wl.plan, wl.tc)
    else:
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
        "card": card, "config": wl.cfg.name, "layers": wl.cfg.n_layers,
        "plan": wl.plan.describe() if wl.plan else None, "batch": wl.batch, "seq": wl.seq,
        "optimizer": wl.tc.optimizer, "opt_state_bytes": opt_bytes,
        "adamw_state_bytes": adamw_bytes,
        "step_ms": step_s * 1e3, "tokens_per_s": wl.tokens_per_step / step_s,
        "peak_mem_gb": peak, "profiled_steps": 3, "wall_s": wall_s,
        "device_busy_s": busy_us / 1e6, "idle_share": 1 - busy_us / 1e6 / wall_s,
        "families": families,
    }), flush=True)


if __name__ == "__main__":
    main()
