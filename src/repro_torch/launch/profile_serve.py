"""Where the serving time goes on the card: granite-8b, the chip smoke's
serving workload, or qwen3-moe-30b-a3b's, phi-3-vision-4.2b's,
falcon-mamba-7b's, recurrentgemma-2b's or seamless-m4t-medium's, under
``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve [--out DIR] \
        [--kv-dtype bf16|int8|fp8] [--admission chunked|whole ...] [--spec K]
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --workload qwen3-moe
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --workload phi-3-vision
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --workload falcon-mamba
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --workload recurrentgemma
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --workload seamless

Runs ``workload.granite_serve_workload(kv_dtype=...)`` (the workload of
``chip_smoke.py``'s serve phases; ``--admission whole`` its whole-prompt
twin, ``granite_serve_whole_workload``) once to warm up, then once under the
profiler, and prints one JSON line for each admission given, in order: wall
time, device-busy time and idle share of the window, the device time of each
kernel family, and the isolated times of one decode step (4 slots at 500
cached tokens), one 128-token prefill chunk and one whole-prompt admission's
prefill of 512 tokens (``lm.prefill``, full caches) from CUDA events.
``--spec K`` adds, after them and with the same weights, the speculative
workload (``granite_serve_spec_workload``: whole-prompt admission, K drafts
by prompt lookup): its row also gives the spec counters, decode steps
against verify ticks (K5 and K6 launches a layer) and the isolated time of
one verify pass (4 slots at 500 cached tokens, K + 1 rows). The full
operator table goes to ``DIR/<admission>`` (``DIR/spec``).

``--workload qwen3-moe`` profiles ``workload.qwen3_moe_serve_workload``
(whole-prompt admission at exact shapes) instead, into ``DIR/moe``. Its row
splits the MoE layers' device time into the expert products (the kernels
that ``aten::bmm`` launched) and the routing's own kernels (softmax, the
top-k and slot sorts, bincount, searchsorted), and adds the isolated time of
one layer's ``moe_apply`` at the decode step's 4 rows, of its three expert
products alone, and the byte floor of a step that reads every expert.

``--workload phi-3-vision`` profiles ``workload.phi3_vision_serve_workload``
(each request behind its 576-patch image, admitted whole) into
``DIR/vision``: its decode step is timed at 500 text tokens behind the
image, its whole-prompt prefill is the image and 512 text tokens, and it
has no chunk (a vision request is never chunked).

``--workload falcon-mamba`` profiles ``workload.falcon_mamba_serve_workload``
(the SSM on the engine's dense fallback) into ``DIR/ssm``. It has no pool:
its isolated times are one dense ``decode_step`` at B 1 after a 500-token
prefill, one whole-prompt prefill of 512 tokens, and the pieces of one
layer's ``mamba_apply`` at S 512 (``ssm_coeffs_ms``: the discretised a and
b; ``ssm_scan_ms``: the associative scan over them; ``ssm_layer_ms``: the
whole block), from which ``ssm_scan_share_of_prefill`` = L x the scan over
the prefill.

``--workload recurrentgemma`` profiles
``workload.recurrentgemma_serve_workload`` (the RG-LRU hybrid, dense) into
``DIR/hybrid`` with the same isolated decode step and prefill, and the
pieces of the first RG-LRU layer at S 512 (``rglru_gates_ms``: a and the
gated input from the block-diagonal gates; ``rglru_scan_ms``: the
associative scan; ``rglru_layer_ms``: the whole block), whose shares of the
prefill count the 18 RG-LRU layers.

``--workload seamless`` profiles ``workload.seamless_serve_workload`` (the
encoder-decoder, dense, each request behind its 1,024 audio frames) into
``DIR/encdec``: one dense ``decode_step`` at B 1 after a 500-token prefill,
one whole-prompt prefill of 512 tokens behind its frames, and the encoder
alone over the frames (``encode_ms``, and ``encode_share_of_prefill``).
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


def _self_device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _pool(name: str) -> str:
    """A paged split kernel's pool variant, from its template arguments."""
    if "fp8_e4m3" in name:
        return " fp8"
    return " int8" if "signed char" in name else ""


ROUTING = ("softmax", "sort", "histogram", "bincount", "searchsorted")


def _family(name: str, moe: bool = False) -> str:
    """K5 / K6 by op: the split kernels by pool variant, the combines (which
    never read the pool) apart; then the model's other kernels by kind (for
    a MoE config, the router's softmax, sorts, bincount and searchsorted as
    routing; a dense config's families are as before)."""
    for op, k in (("paged_decode", "K5"), ("paged_prefill", "K6")):
        if op in name:
            if "combine" in name:
                return f"{k} {op}_combine"
            return f"{k} {op}_kernel{_pool(name)}"
    if "fa_fwd" in name:
        return "K1 flash_attention_fwd"
    if "rmsnorm_fwd" in name:
        return "K3 rmsnorm_fwd"
    low = name.lower()
    if moe and any(k in low for k in ROUTING):
        return "MoE routing (softmax, sort, bincount, searchsorted)"
    if any(k in low for k in ("gemm", "gemv", "nvjet", "cutlass", "splitkreduce")):
        return "matmul (cuBLAS)"
    if "index" in low or "scatter" in low:
        return "index/scatter (KV writes, gathers)"
    return "other elementwise/reduction"


def _events_ms(fn, reps: int = 10) -> float:
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def profiled_run(wl, params, out: Path) -> dict:
    """The workload's requests through a warm engine, once under the
    profiler: wall time, device-busy time, the device time of each kernel
    family (the operator table to ``out``), the engine's stats, peak memory,
    and the device time of the kernels that ``aten::bmm`` launched."""
    from repro_torch.serve import ServeEngine

    cfg, rt, ecfg = wl.cfg, wl.rt, wl.ecfg
    eng = ServeEngine(cfg, params, rt, ecfg, device="cuda")
    for i, p in enumerate(wl.prompts):                 # warm-up run
        eng.submit(p, wl.new_tokens, frontend_embeds=wl.image(i))
    eng.run()
    stats0 = dict(eng.stats)
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # submitted inside the window: the profiler's start-up is not a TTFT
        rids = [eng.submit(p, wl.new_tokens, frontend_embeds=wl.image(i))
                for i, p in enumerate(wl.prompts)]
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    stats = dict(eng.stats)
    families: dict = {}
    busy_us = 0.0
    averages = prof.key_averages()          # slow on ~10^6 events: once
    for evt in averages:
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = _self_device_us(evt)
        busy_us += us
        fam = families.setdefault(_family(evt.key, cfg.ffn_kind == "moe"), {"ms": 0.0, "calls": 0})
        fam["ms"] += us / 1e3
        fam["calls"] += evt.count
    # the expert products: the kernels whose launching op is aten::bmm (the
    # serving path's one batched product)
    bmm_us = sum(k.duration for evt in prof.events() if evt.name == "aten::bmm"
                 for k in evt.kernels)
    out.mkdir(parents=True, exist_ok=True)
    (out / "key_averages.txt").write_text(averages.table(
        sort_by="self_cuda_time_total", row_limit=60))
    del eng
    return dict(stats=stats, stats0=stats0, rids=rids, wall_s=wall_s, busy_us=busy_us,
                families=families, peak=peak, bmm_us=bmm_us)


def profile_one(wl, params, card: str, out: Path) -> dict:
    """One workload's profiled run and isolated step times (see above)."""
    from repro_torch.models import (decode_step_paged, init_paged_state, prefill,
                                    prefill_chunk_paged, verify_step_paged)
    from repro_torch.serve.engine import SPEC_COUNTERS

    cfg, rt, ecfg = wl.cfg, wl.rt, wl.ecfg
    run = profiled_run(wl, params, out)
    stats, families, rids = run["stats"], run["families"], run["rids"]

    # isolated step times: 4 slots decoding at 500 cached tokens (behind an
    # image); one chunk; one whole-prompt prefill of 512 tokens (and an image)
    vision = wl.frontend_embeds is not None
    cached = 500 + (cfg.frontend_tokens if vision else 0)
    state = init_paged_state(cfg, 4, rt, num_pages=ecfg.num_pages, page_size=16,
                             max_len=ecfg.max_len, device="cuda")
    width = state["tables"].shape[1]
    state["tables"].copy_(torch.arange(1, 1 + 4 * width, device="cuda").view(4, width)
                          .clamp(max=ecfg.num_pages - 1).int())
    state["lengths"].fill_(cached)
    tok = torch.zeros(4, dtype=torch.int32, device="cuda")
    chunk = torch.zeros(128, dtype=torch.int32, device="cuda")
    prompt = {"tokens": torch.zeros((1, 512), dtype=torch.int32, device="cuda")}
    if vision:
        prompt["frontend_embeds"] = torch.from_numpy(wl.image(0)[None]).to("cuda")

    def decode():
        decode_step_paged(cfg, params, state, tok, rt, ecfg.max_len)
        state["lengths"].fill_(cached)

    def chunk_prefill():
        prefill_chunk_paged(cfg, params, state["caches"], state["tables"][0], chunk,
                            384, 128, rt, ecfg.max_len)

    def whole_prefill():
        prefill(cfg, params, prompt, rt, full_cache=True)

    k = ecfg.spec_tokens
    rows = torch.zeros((4, k + 1), dtype=torch.int32, device="cuda")
    q_len = torch.full((4,), k + 1, dtype=torch.int32, device="cuda")

    def verify():
        verify_step_paged(cfg, params, state, rows, q_len, rt, ecfg.max_len)

    with torch.no_grad():
        decode(), whole_prefill()
        times = {"decode_step_ms": _events_ms(decode),
                 "whole_prefill_512_ms": _events_ms(whole_prefill)}
        if not vision:
            chunk_prefill()
            times["prefill_chunk_ms"] = _events_ms(chunk_prefill)
        if k:
            verify()
            times["verify_step_ms"] = _events_ms(verify)
        if cfg.ffn_kind == "moe":
            times.update(_moe_times(cfg, params))
    launches, L = stats["kernel_launches"], cfg.n_layers
    pool = "" if ecfg.kv_dtype == "bf16" else f"_{ecfg.kv_dtype}"
    spec = {}
    if k:
        spec = {key: stats[key] - run["stats0"].get(key, 0) for key in SPEC_COUNTERS}
        spec.update(spec_tokens=k, spec_drafter=ecfg.spec_drafter,
                    spec_accept_rate=stats["spec_accept_rate"],
                    spec_accepted_per_verify=stats["spec_accepted_per_verify"])
    moe = {}
    if cfg.ffn_kind == "moe":
        moe = {"moe_expert_bmm_ms": run["bmm_us"] / 1e3,
               "moe_routing_ms": sum(f["ms"] for n, f in families.items()
                                     if n.startswith("MoE routing"))}
    return {
        "card": card, "config": cfg.name, "kv_dtype": ecfg.kv_dtype, **moe,
        "admission": "chunked" if ecfg.prefill_chunk else "whole", **spec,
        "decode_steps": launches[f"paged_decode_attention{pool}"] // L,
        "verify_ticks": launches[f"paged_prefill_attention{pool}"] // L if k else 0,
        **_run_row(run), **times,
    }


def _run_row(run: dict) -> dict:
    stats, busy_s = run["stats"], run["busy_us"] / 1e6
    return {"wall_s": run["wall_s"], "device_busy_s": busy_s,
            "idle_share": 1 - busy_s / run["wall_s"],
            "tokens_per_s": stats["tokens_per_s"], "run_mean_ttft_s": stats["run_mean_ttft_s"],
            "prefill_s": [stats["prefill_s"][r] for r in run["rids"]],
            "peak_mem_bytes": run["peak"], "kernel_launches": stats["kernel_launches"],
            "families": run["families"]}


def profile_recurrent(wl, params, card: str, out: Path) -> dict:
    """A recurrent workload's profiled run (the dense fallback) and its
    isolated times (see above), its mixer's pieces under ``ssm_`` (Mamba)
    or ``rglru_`` (RG-LRU) keys."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.models import rglru, ssm
    from repro_torch.models.layers import norm_apply

    cfg, rt = wl.cfg, wl.rt
    run = profiled_run(wl, params, out)
    S = 512
    kind = "mamba" if "mamba" in cfg.pattern else "rglru"
    L = sum(k == kind for k in cfg.mixer_kinds())
    prompt = {"tokens": torch.zeros((1, S), dtype=torch.int32, device="cuda")}
    layer = params.stack.layers[cfg.mixer_kinds().index(kind)]
    m = layer.mixer
    with torch.no_grad():
        _, state = prefill(cfg, params, {"tokens": prompt["tokens"][:, :500]}, rt)
        tok = torch.zeros(1, dtype=torch.int32, device="cuda")
        h = norm_apply(layer.norm1, torch.randn(1, S, cfg.d_model, device="cuda").to(rt.dtype),
                       cfg.norm)
        fns = {
            "decode_step_ms": lambda: decode_step(cfg, params, state, tok, rt, S + 64),
            "whole_prefill_512_ms": lambda: prefill(cfg, params, prompt, rt),
        }
        if kind == "mamba":
            x_in = (h @ m.in_proj.to(rt.dtype))[..., :cfg.d_inner]
            x_conv = ssm.silu(ssm._causal_conv(x_in, m.conv_w.to(rt.dtype), m.conv_b))
            a, b, _ = ssm._ssm_coeffs(m, x_conv)
            fns.update({
                "ssm_layer_ms": lambda: ssm.mamba_apply(m, h),
                "ssm_coeffs_ms": lambda: ssm._ssm_coeffs(m, x_conv),
                "ssm_scan_ms": lambda: ssm.assoc_scan(a, b, keep_a=False),
            })
        else:
            u = ssm._causal_conv(h @ m.w_in.to(rt.dtype), m.conv_w.to(rt.dtype), m.conv_b)
            a, b = rglru._gates(m, u)
            fns.update({
                "rglru_layer_ms": lambda: rglru.rglru_apply(m, h),
                "rglru_gates_ms": lambda: rglru._gates(m, u),
                "rglru_scan_ms": lambda: ssm.assoc_scan(a, b, keep_a=False),
            })
        times = {}
        for name, fn in fns.items():
            fn()
            times[name] = _events_ms(fn)
    prefill_ms = times["whole_prefill_512_ms"]
    pre = "ssm" if kind == "mamba" else "rglru"
    times[f"{pre}_scan_share_of_prefill"] = L * times[f"{pre}_scan_ms"] / prefill_ms
    times[f"{pre}_layers_share_of_prefill"] = L * times[f"{pre}_layer_ms"] / prefill_ms
    return {"card": card, "config": cfg.name, "admission": "dense",
            "requests": len(wl.prompts), **_run_row(run), **times}


def profile_encdec(wl, params, card: str, out: Path) -> dict:
    """The encoder-decoder workload's profiled run (the dense path) and its
    isolated times (see above)."""
    from repro_torch.models import decode_step, encode, prefill

    cfg, rt = wl.cfg, wl.rt
    run = profiled_run(wl, params, out)
    frames = torch.from_numpy(wl.image(0)[None]).to("cuda")
    prompt = {"tokens": torch.zeros((1, 512), dtype=torch.int32, device="cuda"),
              "frontend_embeds": frames}
    with torch.no_grad():
        _, state = prefill(cfg, params, {"tokens": prompt["tokens"][:, :500],
                                         "frontend_embeds": frames}, rt, max_len=564)
        tok = torch.zeros(1, dtype=torch.int32, device="cuda")
        fns = {"decode_step_ms": lambda: decode_step(cfg, params, state, tok, rt, 564),
               "whole_prefill_512_ms": lambda: prefill(cfg, params, prompt, rt),
               "encode_ms": lambda: encode(cfg, params, frames, rt)}
        times = {}
        for name, fn in fns.items():
            fn()
            times[name] = _events_ms(fn)
    times["encode_share_of_prefill"] = times["encode_ms"] / times["whole_prefill_512_ms"]
    return {"card": card, "config": cfg.name, "admission": "dense",
            "requests": len(wl.prompts), "frames": cfg.frontend_tokens, **_run_row(run),
            **times}


def _moe_times(cfg, params) -> dict:
    """Layer 0's moe_apply at the decode step's 4 rows, its three expert
    products alone (at the capacity of 4 rows), and the byte floor of a
    decode step that reads every expert's weights (JAX's dense (E, C, d)
    buffer) at the card's memory rate."""
    from repro_torch.launch.timing import HBM_BYTES_PER_S
    from repro_torch.models.moe import capacity, moe_apply

    moe = params.stack.layers[0].ffn
    E, d, f = moe.w_up.shape
    x = torch.randn(4, 1, d, device="cuda").to(moe.w_up.dtype)
    C = capacity(4, cfg.experts_top_k, E, cfg.capacity_factor)
    xin = torch.randn(E, C, d, device="cuda").to(moe.w_up.dtype)

    def layer():
        moe_apply(moe, x, top_k=cfg.experts_top_k, capacity_factor=cfg.capacity_factor,
                  gated=cfg.mlp_gated)

    def experts():
        h = torch.nn.functional.silu(torch.bmm(xin, moe.w_gate)) * torch.bmm(xin, moe.w_up)
        torch.bmm(h, moe.w_down)

    layer(), experts()
    expert_bytes = cfg.n_layers * sum(w.numel() * w.element_size()
                                      for w in (moe.w_up, moe.w_gate, moe.w_down))
    return {"moe_layer_decode_ms": _events_ms(layer),
            "moe_experts_decode_ms": _events_ms(experts),
            "moe_expert_bytes_step": expert_bytes,
            "moe_expert_floor_ms": expert_bytes / HBM_BYTES_PER_S * 1e3}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="profile_serve_out")
    ap.add_argument("--kv-dtype", default="bf16", choices=("bf16", "int8", "fp8"))
    ap.add_argument("--admission", nargs="+", default=["chunked"],
                    choices=("chunked", "whole"),
                    help="chunked prefill (the serve workload) and/or whole-prompt "
                         "admission, profiled in this order with the same weights")
    ap.add_argument("--spec", type=int, default=0, metavar="K",
                    help="then the speculative workload: K drafts a slot a tick")
    ap.add_argument("--workload", default="granite",
                    choices=("granite", "qwen3-moe", "phi-3-vision", "falcon-mamba",
                             "recurrentgemma", "seamless"),
                    help="qwen3-moe: qwen3_moe_serve_workload; phi-3-vision: "
                         "phi3_vision_serve_workload (whole prompts); falcon-mamba: "
                         "falcon_mamba_serve_workload (dense); recurrentgemma: "
                         "recurrentgemma_serve_workload (dense); seamless: "
                         "seamless_serve_workload (dense); --admission, "
                         "--kv-dtype and --spec do not apply to them")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve measures the card; CUDA is not available")

    from repro_torch.launch.workload import (falcon_mamba_serve_workload,
                                             granite_serve_spec_workload,
                                             granite_serve_workload,
                                             phi3_vision_serve_workload,
                                             qwen3_moe_serve_workload,
                                             recurrentgemma_serve_workload,
                                             seamless_serve_workload)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    params = None
    runs = [(a, granite_serve_workload(kv_dtype=args.kv_dtype,
                                       prefill_chunk=128 if a == "chunked" else 0))
            for a in args.admission]
    if args.spec:
        runs.append(("spec", granite_serve_spec_workload(kv_dtype=args.kv_dtype,
                                                         spec_tokens=args.spec)))
    if args.workload == "qwen3-moe":
        runs = [("moe", qwen3_moe_serve_workload())]
    if args.workload == "phi-3-vision":
        runs = [("vision", phi3_vision_serve_workload())]
    if args.workload == "falcon-mamba":
        runs = [("ssm", falcon_mamba_serve_workload())]
    if args.workload == "recurrentgemma":
        runs = [("hybrid", recurrentgemma_serve_workload())]
    if args.workload == "seamless":
        runs = [("encdec", seamless_serve_workload())]
    for name, wl in runs:
        if params is None:
            params = wl.params("cuda")
        profile = (profile_recurrent if name in ("ssm", "hybrid") else
                   profile_encdec if name == "encdec" else profile_one)
        row = profile(wl, params, card, Path(args.out) / name)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
