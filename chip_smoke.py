"""Smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order (any failure exits nonzero and prints no result line):
  1. card    — the card's name and power limit from nvidia-smi;
  2. build   — nvcc builds the paged-attention kernels from csrc/;
  3. kernels — K5 (paged decode) and K6 (paged prefill) against their plain
               PyTorch versions: f32 cases of the JAX package's kernel tests
               plus multi-tile K6 chunks (atol/rtol 2e-5), and bf16 cases at
               the serving path's shapes (atol/rtol 4e-3: both sides compute
               in f32 and round once to bf16), with times, bounds and a
               library yardstick;
  4. model   — reduced granite-8b on the card (kernels) against the same
               model on the CPU (plain versions), f32, rtol 1e-3;
  5. serve   — launch/workload.py's granite-8b workload at full width and
               depth, bf16, random weights from a seed: 8 requests through
               ServeEngine (chunked prefill 128, 4 slots, page 16), launch
               counters read around this run only;
  6. alone   — 2 of the requests rerun alone in a fresh engine must give the
               same greedy tokens.
The line before last lists every kernel as JSON; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

HBM_BYTES_PER_S = 3.35e12         # H100 SXM HBM3
BF16_FLOPS = 989e12               # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12                 # H100 SXM float32 outside the tensor cores
BF16_TOL = 4e-3                   # ~1 bf16 ulp at |out| ~1; outputs here are < 1
# each CUDA kernel and the TPU kernel it replaces (paged_attention_kernel,
# paged_prefill_attention_kernel)
REPLACES = {
    "paged_decode_attention": "src/repro/kernels/paged_attention/kernel.py:262",
    "paged_prefill_attention": "src/repro/kernels/paged_attention/kernel.py:195",
}
SOURCE = "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu"


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


# ------------------------------------------------------------------ cases
def make_decode_case(B, Kv, G, hd, page, N, P, lengths, dtype, seed=0, dev="cuda"):
    """Random pool and disjoint block tables covering ``lengths`` tokens."""
    rng = np.random.RandomState(seed)
    q = torch.tensor(rng.randn(B, Kv, G, hd) * hd ** -0.5, dtype=torch.float32)
    kp = torch.tensor(rng.randn(N, page, Kv, hd), dtype=torch.float32)
    vp = torch.tensor(rng.randn(N, page, Kv, hd), dtype=torch.float32)
    tables = np.zeros((B, P), np.int32)
    nxt = 1
    for b, L in enumerate(lengths):
        n = -(-L // page)
        tables[b, :n] = np.arange(nxt, nxt + n)
        nxt += n
    assert nxt <= N
    return (q.to(dev, dtype), kp.to(dev, dtype), vp.to(dev, dtype),
            torch.tensor(tables, device=dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def make_prefill_case(B, T, Kv, G, hd, page, N, P, starts, qlens, dtype, seed=0,
                      dev="cuda"):
    rng = np.random.RandomState(seed)
    q = torch.tensor(rng.randn(B, T, Kv, G, hd) * hd ** -0.5, dtype=torch.float32)
    kp = torch.tensor(rng.randn(N, page, Kv, hd), dtype=torch.float32)
    vp = torch.tensor(rng.randn(N, page, Kv, hd), dtype=torch.float32)
    tables = np.zeros((B, P), np.int32)
    nxt = 1
    for b in range(B):
        n = -(-(starts[b] + T) // page)
        tables[b, :n] = np.arange(nxt, nxt + n)
        nxt += n
    assert nxt <= N
    return (q.to(dev, dtype), kp.to(dev, dtype), vp.to(dev, dtype),
            torch.tensor(tables, device=dev),
            torch.tensor(starts, dtype=torch.int32, device=dev),
            torch.tensor(qlens, dtype=torch.int32, device=dev))


# the JAX package's tests/test_paged_attention.py CASES and PREFILL_CASES
DECODE_CASES = [
    (1, 1, 1, 32, 8, 8, 4, [13]),
    (3, 2, 4, 32, 8, 32, 4, [13, 27, 5]),
    (2, 4, 2, 64, 16, 16, 4, [64, 33]),
    (2, 2, 8, 32, 4, 32, 8, [1, 31]),
]
PREFILL_CASES = [
    (1, 8, 1, 4, 32, 4, 24, 12, [0], [8]),
    (2, 4, 2, 2, 32, 8, 16, 4, [0, 5], [4, 3]),
    (1, 8, 1, 4, 32, 4, 24, 12, [13], [6]),
    (3, 4, 2, 4, 16, 8, 32, 4, [0, 9, 17], [4, 2, 1]),
]
# K6 chunks of more than one 32-row tile (T*G > 32), at nonzero starts, so
# that the tile offset and, at window 6, the page skip below a later tile's
# window are checked at 2e-5. G=3 puts a tile edge inside a position's rows.
MULTI_TILE_CASES = [
    (2, 16, 2, 4, 32, 4, 16, 8, [5, 13], [16, 11]),
    (1, 12, 1, 3, 64, 8, 8, 4, [9], [12]),
    (1, 16, 2, 4, 128, 16, 8, 6, [40], [16]),
]


def max_err(out, ref, qlens=None) -> float:
    if qlens is None:
        return float((out.float() - ref.float()).abs().max())
    return max(
        float((out[b, :L].float() - ref[b, :L].float()).abs().max())
        for b, L in enumerate(qlens.tolist())
    )


def check(name, out, ref, tol, qlens=None) -> float:
    """Kernel vs plain; rows t >= q_len of a prefill chunk are garbage."""
    torch.cuda.synchronize()
    if qlens is None:
        pairs = [(out, ref)]
    else:
        pairs = [(out[b, :L], ref[b, :L]) for b, L in enumerate(qlens.tolist())]
    for o, r in pairs:
        if not torch.isfinite(o).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        torch.testing.assert_close(o.float(), r.float(), atol=tol, rtol=tol,
                                   msg=lambda m: f"{name}: {m}")
    return max_err(out, ref, qlens)


# ----------------------------------------------------------------- timing
def time_ms(fn, flush, warmup=5, reps=30) -> float:
    """Median of ``reps`` CUDA-event timings, the L2 flushed before each."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def visible_keys(qpos: int, window: int) -> int:
    n = qpos + 1
    return min(n, window) if window > 0 else n


def extent_bytes(lo_pos: int, end_tok: int, page: int, Kv: int, hd: int,
                 isz: int, window: int) -> int:
    """Least bytes of K, V and block table that rows at positions lo_pos ..
    end_tok-1 need: the K/V rows from the lowest row's window start (0
    without a window) to end_tok, and the table entries of their pages."""
    first = max(0, lo_pos - window + 1) if window > 0 else 0
    if end_tok <= first:
        return 0
    entries = (end_tok - 1) // page - first // page + 1
    return 2 * (end_tok - first) * Kv * hd * isz + 4 * entries


def decode_bound(q, kp, tables, lengths, window):
    B, Kv, G, hd = q.shape
    page = kp.shape[1]
    isz = q.element_size()
    nbytes = 2 * q.numel() * isz + lengths.numel() * 4      # q in, out, lengths
    flops = 0
    for L in lengths.tolist():
        nbytes += extent_bytes(L - 1, L, page, Kv, hd, isz, window)
        flops += 4 * hd * G * Kv * visible_keys(L - 1, window)
    return nbytes, flops


def prefill_bound(q, kp, tables, starts, qlens, window):
    B, T, Kv, G, hd = q.shape
    page = kp.shape[1]
    isz = q.element_size()
    row_bytes = Kv * G * hd * isz
    nbytes = 8 * B                                           # start, q_len
    flops = 0
    for s, n in zip(starts.tolist(), qlens.tolist()):
        nbytes += 2 * n * row_bytes         # the q_len valid rows in and out
        nbytes += extent_bytes(s, s + n, page, Kv, hd, isz, window)
        flops += sum(4 * hd * G * Kv * visible_keys(s + t, window) for t in range(n))
    return nbytes, flops


def bound(nbytes, flops, dtype):
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def sdpa_inputs(q, kp, vp, tables, qpos, window):
    """Dense (B, H, S, hd) K/V gathered through the tables, and the boolean
    mask, for F.scaled_dot_product_attention as a yardstick. q: (B, T, Kv,
    G, hd); qpos: (B, T) absolute positions."""
    B, T, Kv, G, hd = q.shape
    page = kp.shape[1]
    n = int(qpos.max()) // page + 1
    S = n * page
    k = kp[tables[:, :n].long()].reshape(B, S, Kv, hd).permute(0, 2, 1, 3)
    v = vp[tables[:, :n].long()].reshape(B, S, Kv, hd).permute(0, 2, 1, 3)
    k = k.repeat_interleave(G, dim=1).contiguous()
    v = v.repeat_interleave(G, dim=1).contiguous()
    qd = q.permute(0, 2, 3, 1, 4).reshape(B, Kv * G, T, hd).contiguous()
    kpos = torch.arange(S, device=q.device)
    mask = kpos[None, None, :] <= qpos[:, :, None]
    if window > 0:
        mask &= kpos[None, None, :] > qpos[:, :, None] - window
    return qd, k, v, mask[:, None]


# ----------------------------------------------------------------- phases
def phase_card() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(line, flush=True)
    return line


def phase_build() -> None:
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import cuda

    t0 = time.perf_counter()
    cuda.library()
    log = build.library_path(cuda.SOURCE).with_suffix(".log").read_text()
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "smem" in ln]
    emit(phase="build", seconds=round(time.perf_counter() - t0, 3), ptxas=ptxas)


def phase_kernels():
    from repro_torch.kernels.paged_attention import cuda, ref

    dec, pre = cuda.paged_decode_attention_cuda, cuda.paged_prefill_attention_cuda
    f32 = torch.float32
    n_checked = 0
    # f32: the JAX package's cases, windows 0 and 6, 2e-5
    for case in DECODE_CASES:
        for window in (0, 6):
            args = make_decode_case(*case, f32)
            check(f"K5 f32 {case[:4]} w{window}", dec(*args, window=window),
                  ref.paged_attention_plain(*args, window=window), 2e-5)
            n_checked += 1
    for case in PREFILL_CASES + MULTI_TILE_CASES:
        for window in (0, 6):
            args = make_prefill_case(*case, f32)
            check(f"K6 f32 {case[:4]} w{window}", pre(*args, window=window),
                  ref.paged_prefill_attention_plain(*args, window=window), 2e-5,
                  args[5])
            n_checked += 1
    # poisoned null page: 1e3 / -1e3 never leaks into valid rows
    q, kp, vp, tb, ln = make_decode_case(2, 2, 2, 16, 8, 16, 4, [9, 12], f32, seed=1)
    clean = ref.paged_attention_plain(q, kp, vp, tb, ln)
    kp[0], vp[0] = 1e3, -1e3
    check("K5 poisoned null page", dec(q, kp, vp, tb, ln), clean, 2e-5)
    q, kp, vp, tb, st, ql = make_prefill_case(2, 4, 2, 2, 32, 8, 16, 4, [3, 11], [4, 2],
                                              f32, seed=3)
    clean = ref.paged_prefill_attention_plain(q, kp, vp, tb, st, ql)
    kp[0], vp[0] = 1e3, -1e3
    check("K6 poisoned null page", pre(q, kp, vp, tb, st, ql), clean, 2e-5, ql)
    # T=1 prefill == decode at length start + 1
    q, kp, vp, tb, st, ql = make_prefill_case(2, 1, 2, 2, 16, 8, 16, 4, [6, 11], [1, 1],
                                              f32, seed=7)
    check("K6 T=1 vs K5", pre(q, kp, vp, tb, st, ql)[:, 0],
          dec(q[:, 0].contiguous(), kp, vp, tb, st + 1), 2e-5)
    n_checked += 3
    emit(phase="kernels_f32", cases=n_checked, tol=2e-5)

    bf = torch.bfloat16
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    results = {}
    # bf16 at the serving path's shapes; the granite rows are the main path
    shapes = [
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
    for model, kind, s in shapes:
        if kind == "decode":
            N = 1 + sum(-(-L // s["page"]) for L in s["lengths"])
            args = make_decode_case(s["B"], s["Kv"], s["G"], s["hd"], s["page"], N,
                                    s["P"], s["lengths"], bf, seed=11)
            w = s["window"]
            kern = lambda a=args, w=w: dec(*a, window=w)            # noqa: E731
            plain = lambda a=args, w=w: ref.paged_attention_plain(*a, window=w)  # noqa: E731
            err = check(f"K5 bf16 {model}", kern(), plain(), BF16_TOL)
            nbytes, flops = decode_bound(args[0], args[1], args[3], args[4], w)
            qpos = (args[4].long() - 1)[:, None]
            sd = sdpa_inputs(args[0][:, None], args[1], args[2], args[3], qpos, w)
            name = "paged_decode_attention"
        else:
            N = 1 + s["B"] * -(-(s["starts"][0] + s["T"]) // s["page"])
            args = make_prefill_case(s["B"], s["T"], s["Kv"], s["G"], s["hd"], s["page"],
                                     N, s["P"], s["starts"], s["qlens"], bf, seed=12)
            w = s["window"]
            kern = lambda a=args, w=w: pre(*a, window=w)            # noqa: E731
            plain = lambda a=args, w=w: ref.paged_prefill_attention_plain(*a, window=w)  # noqa: E731
            err = check(f"K6 bf16 {model} q_len {s['qlens']}", kern(), plain(), BF16_TOL,
                        args[5])
            nbytes, flops = prefill_bound(args[0], args[1], args[3], args[4], args[5], w)
            qpos = args[4].long()[:, None] + torch.arange(s["T"], device="cuda")[None]
            sd = sdpa_inputs(args[0], args[1], args[2], args[3], qpos, w)
            name = "paged_prefill_attention"
        qd, kd, vd, mask = sd
        lib = lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask,  # noqa: E731
                                                     scale=1.0)
        bms, by = bound(nbytes, flops, bf)
        row = dict(model=model, kernel=name, shape=s, max_abs_err=err,
                   kernel_ms=time_ms(kern, flush), plain_ms=time_ms(plain, flush),
                   library_ms=time_ms(lib, flush), bound_ms=bms, bound_by=by,
                   bytes=nbytes, flops=flops)
        emit(phase="kernels_bf16", tol=BF16_TOL, **row)
        if model == "granite-8b" and name not in results:
            results[name] = row
    return results


def phase_model() -> None:
    """Reduced granite-8b, f32: the port on the card (kernels) against the
    port on the CPU (plain versions) — prefill chunks, then decode steps."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import (Runtime, decode_step_paged, init_paged_state,
                                    init_params, prefill_chunk_paged)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_reduced("granite-8b", n_kv_heads=2)
    rt = Runtime(dtype=torch.float32)
    cpu = init_params(cfg, seed=3, device="cpu", dtype=torch.float32)
    gpu = init_params(cfg, seed=3, device="cpu", dtype=torch.float32).to("cuda")
    rng = np.random.RandomState(5)
    prompt = rng.randint(0, cfg.vocab_size, 45).astype(np.int32)
    worst = 0.0
    outs = {}
    for dev, params in (("cpu", cpu), ("cuda", gpu)):
        st = init_paged_state(cfg, 2, rt, num_pages=16, page_size=8, max_len=64,
                              device=dev)
        st["tables"][0, :8] = torch.arange(1, 9)
        seq = []
        for s in range(0, 45, 16):
            chunk = np.zeros(16, np.int32)
            n = min(16, 45 - s)
            chunk[:n] = prompt[s:s + n]
            seq.append(prefill_chunk_paged(cfg, params, st["caches"], st["tables"][0],
                                           torch.from_numpy(chunk).to(dev), s, n, rt, 64))
        st["lengths"][0] = 45
        tok = torch.tensor([int(seq[-1].argmax()), 0], dtype=torch.int32, device=dev)
        act = torch.tensor([True, False], device=dev)
        for _ in range(4):
            lg = decode_step_paged(cfg, params, st, tok, rt, 64, active=act)
            seq.append(lg[0])
            tok = torch.stack([lg[0].argmax().int(), tok[1]])
        outs[dev] = [x.float().cpu() for x in seq]
    for a, b in zip(outs["cpu"], outs["cuda"]):
        if not torch.isfinite(b).all():
            raise AssertionError("non-finite logits on the card")
        torch.testing.assert_close(b, a, atol=1e-3, rtol=1e-3)
        worst = max(worst, float((a - b).abs().max() / a.abs().max()))
    emit(phase="model", config=cfg.name, max_rel_err=worst, tol=1e-3)


def phase_serve():
    from repro_torch.kernels.paged_attention import cuda
    from repro_torch.launch.workload import granite_serve_workload
    from repro_torch.serve import ServeEngine

    wl = granite_serve_workload()
    cfg, rt, ecfg, prompts, new = wl.cfg, wl.rt, wl.ecfg, wl.prompts, wl.new_tokens
    t0 = time.perf_counter()
    params = wl.params("cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = ServeEngine(cfg, params, rt, ecfg, device="cuda")
    eng.submit(prompts[0][:32], 4)         # warm-up: cuBLAS handles, allocator
    eng.run()
    torch.cuda.reset_peak_memory_stats()
    chunks0 = eng.stats["prefill_chunks"]
    rids = [eng.submit(p, new) for p in prompts]
    cuda.reset_launches()                  # counts of the main path only
    out = eng.run()
    launches = dict(cuda.LAUNCHES)
    s = eng.stats
    for rid in rids:
        if out[rid].shape != (new,):
            raise AssertionError(f"request {rid} produced {out[rid].shape}")
        if not ((out[rid] >= 0) & (out[rid] < cfg.vocab_size)).all():
            raise AssertionError(f"request {rid} produced ids outside the vocab")
    L = cfg.n_layers
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched on the main path: {launches}")
    chunks = s["prefill_chunks"] - chunks0
    if launches["paged_prefill_attention"] != L * chunks:
        raise AssertionError(f"K6 launches {launches} != {L} x {chunks}")
    if launches["paged_decode_attention"] % L:
        raise AssertionError(f"K5 launches {launches} not a multiple of {L}")
    emit(phase="serve", config=cfg.name, dtype="bf16", params_init_s=init_s,
         requests=len(rids), new_tokens=new, num_pages=ecfg.num_pages,
         tokens_per_s=s["tokens_per_s"], run_mean_ttft_s=s["run_mean_ttft_s"],
         wall_s=s["wall_s"], prefill_chunks=chunks,
         decode_steps=launches["paged_decode_attention"] // L,
         launches=launches, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del eng
    torch.cuda.empty_cache()
    return wl, params, rids, out, launches


def phase_alone(wl, params, rids, out) -> None:
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(wl.cfg, params, wl.rt, wl.ecfg, device="cuda")
    for i in (0, 5):
        rid = eng.submit(wl.prompts[i], wl.new_tokens)
        alone = eng.run()[rid]
        if not np.array_equal(alone, out[rids[i]]):
            raise AssertionError(f"request {i}: batched {out[rids[i]][:8]} != "
                                 f"alone {alone[:8]}")
    emit(phase="alone", requests=[0, 5], identical=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    phase_card()
    phase_build()
    kern = phase_kernels()
    phase_model()
    wl, params, rids, out, launches = phase_serve()
    phase_alone(wl, params, rids, out)
    rows = []
    for name, replaces in REPLACES.items():
        r = kern[name]
        rows.append(dict(name=name, route="cuda", source=SOURCE, replaces=replaces,
                         launches=launches[name], max_abs_err=r["max_abs_err"],
                         ms=r["kernel_ms"], plain_ms=r["plain_ms"],
                         bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                         library_ms=r["library_ms"]))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
