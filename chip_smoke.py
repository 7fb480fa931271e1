"""Smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order (any failure exits nonzero and prints no result line):
  1. card    — the card's name and power limit from nvidia-smi;
  2. build   — nvcc builds every kernel source from the checkout, one nvcc per
               source, all started together;
  3. kernels — K5 (paged decode) and K6 (paged prefill) against their plain
               PyTorch versions: f32 cases of the JAX package's kernel tests
               plus multi-tile K6 chunks (atol/rtol 2e-5), and bf16 cases at
               the serving path's shapes (atol/rtol 4e-3: both sides compute
               in f32 and round once to bf16), with times, bounds and a
               library yardstick;
  4. train kernels — K1 (flash forward), K2 (its delta, dq and dk/dv
               launches), K3 and K4 (RMSNorm forward, backward) against their
               plain versions: f32 on the JAX suites' shapes (forward 2e-5,
               gradients 1e-4), bf16 at gemma3-1b's training shapes and
               granite-8b's, with times, bounds and a library yardstick;
  5. model   — reduced granite-8b on the card (kernels) against the same
               model on the CPU (plain versions), f32, rtol 1e-3;
  6. train-parity — reduced gemma3-1b, f32 with TF32 off: three training
               steps on the card against the same steps on the CPU, rtol 1e-3;
  7. train   — gemma3-1b at full width and depth, bf16 over f32 masters,
               AdamW, batch 4 x seq 2048, 10 steps through train.loop.fit;
               launch counters read around this run only;
  8. serve   — launch/workload.py's granite-8b workload at full width and
               depth, bf16, random weights from a seed: 8 requests through
               ServeEngine (chunked prefill 128, 4 slots, page 16), launch
               counters read around this run only;
  9. alone   — 2 of the requests rerun alone in a fresh engine must give the
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
from concurrent.futures import ThreadPoolExecutor
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
PA_SOURCE = "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu"
FA_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
RN_SOURCE = "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu"
# each CUDA kernel: its source and the TPU kernel it replaces
KERNELS = {
    "paged_decode_attention": (PA_SOURCE, "src/repro/kernels/paged_attention/kernel.py:262"),
    "paged_prefill_attention": (PA_SOURCE, "src/repro/kernels/paged_attention/kernel.py:195"),
    "flash_attention_fwd": (FA_SOURCE, "src/repro/kernels/flash_attention/kernel.py:120"),
    "flash_attention_bwd_delta": (FA_SOURCE,
                                  "src/repro/kernels/flash_attention/kernel_bwd.py:172"),
    "flash_attention_bwd_dq": (FA_SOURCE, "src/repro/kernels/flash_attention/kernel_bwd.py:185"),
    "flash_attention_bwd_dkv": (FA_SOURCE,
                                "src/repro/kernels/flash_attention/kernel_bwd.py:212"),
    "rmsnorm_fwd": (RN_SOURCE, "src/repro/kernels/rmsnorm/kernel.py:67"),
    "rmsnorm_bwd": (RN_SOURCE, "src/repro/kernels/rmsnorm/kernel.py:93"),
}


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
    from repro_torch.kernels.flash_attention import cuda as fa
    from repro_torch.kernels.paged_attention import cuda as pa
    from repro_torch.kernels.rmsnorm import cuda as rn

    t0 = time.perf_counter()
    mods = (pa, fa, rn)
    with ThreadPoolExecutor(len(mods)) as ex:       # one nvcc per source, together
        list(ex.map(lambda m: m.library(), mods))
    ptxas = {}
    for m in mods:
        log = build.library_path(m.SOURCE).with_suffix(".log").read_text().splitlines()
        regs = [int(ln.split("Used ")[1].split()[0]) for ln in log if "registers" in ln]
        spills = [ln.strip() for ln in log if "spill" in ln and not ln.strip().startswith("0 bytes")]
        ptxas[m.SOURCE] = dict(kernels=len(regs), max_registers=max(regs), spills=spills)
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


# ------------------------------------------------------ training kernels
# tests/test_kernels_flash.py SHAPES (B, S, Kv, G, hd), and
# tests/test_kernels_backward.py FA_CASES (B, S, Kv, G, hd, causal, window)
FA_SHAPES = [(1, 128, 1, 1, 64), (2, 256, 2, 4, 32), (1, 512, 4, 1, 128)]
FA_CASES = [
    (1, 128, 2, 1, 32, True, 0),
    (2, 64, 1, 4, 16, True, 0),
    (1, 128, 2, 2, 32, False, 0),
    (1, 128, 2, 2, 16, True, 32),
    (1, 130, 2, 2, 16, True, 0),
    (1, 250, 1, 2, 16, True, 64),
]
FA_F32_TOL = 2e-5                 # forward: f32, sums in another order
FA_F32_GRAD_TOL = 1e-4            # gradients: f32 sums over k blocks in another order
# bf16 gradients are compared against max|ref|: both sides compute in f32
# from the same bf16 inputs and round once to bf16, so the largest elements
# may differ by a bf16 ulp (2**-8..2**-7 of their size), and the kernel's
# delta reads its own bf16-rounded O where the plain version recomputes O
FA_BF16_GRAD_REL = 1e-2
RN_BF16_TOL = 1e-2                # one bf16 ulp (2**-8..2**-7 relative) of out / dx
RN_DSCALE_TOL = 1e-4              # f32 on both sides, another summation order
# the training path's shapes: gemma3-1b at batch 4 x seq 2048 (16 query
# heads over 4 kv heads of hd 256; 4 global layers, 22 with window 512) and
# granite-8b's (Kv 8, G 4, hd 128) at one sequence of 2048
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 2048, 10
GEMMA_FA = [dict(B=TRAIN_B, S=TRAIN_S, Kv=1, G=4, hd=256, window=0, layers=4),
            dict(B=TRAIN_B, S=TRAIN_S, Kv=1, G=4, hd=256, window=512, layers=22)]
GRANITE_FA = dict(B=1, S=2048, Kv=8, G=4, hd=128, window=0)
RN_SHAPES = [(TRAIN_B * TRAIN_S, 1152), (TRAIN_B * TRAIN_S, 4096)]


def fa_flat(B, S, Kv, G, hd, dtype, seed, dev="cuda"):
    """q, k, v, dO in the kernels' flat layout, from numpy."""
    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        return torch.tensor(rng.randn(*shape) * scale, dtype=torch.float32).to(dev, dtype)

    return (t(B * Kv * G, S, hd, scale=hd ** -0.5), t(B * Kv, S, hd), t(B * Kv, S, hd),
            t(B * Kv * G, S, hd))


def visible_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs a head attends to: the unmasked work."""
    from repro_torch.kernels.flash_attention.ref import visible_mask

    return int(visible_mask(S, S, causal=causal, window=window, device="cpu").sum())


def fa_bounds(B, S, Kv, G, hd, window, isz, causal=True):
    """(bytes, flops) each K1/K2 launch must move and do: every input read
    once, every output written once; the products of the unmasked pairs."""
    BH = B * Kv * G
    q, kv, row = BH * S * hd * isz, B * Kv * S * hd * isz, BH * S * 4
    pairs = BH * visible_pairs(S, causal, window)
    return {
        "flash_attention_fwd": (2 * q + 2 * kv + row, 4 * hd * pairs),
        "flash_attention_bwd_delta": (2 * q + row, 2 * hd * BH * S),
        "flash_attention_bwd_dq": (3 * q + 2 * kv + 2 * row, 6 * hd * pairs),
        "flash_attention_bwd_dkv": (2 * q + 4 * kv + 2 * row, 8 * hd * pairs),
    }


def rel_err(out, ref) -> float:
    return float((out.float() - ref.float()).abs().max() / ref.float().abs().max())


def fa_check(tag, q, k, v, do, kw, bf16):
    """K1 and K2's three launches against the plain versions on the same
    inputs. Returns the max abs error of each kernel."""
    from repro_torch.kernels.flash_attention import cuda as fa
    from repro_torch.kernels.flash_attention import ref as far

    o, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
    po, plse = far.flash_attention_fwd_plain(q, k, v, **kw)
    tol = BF16_TOL if bf16 else FA_F32_TOL
    err = {"flash_attention_fwd": max(check(f"{tag} K1 o", o, po, tol),
                                      check(f"{tag} K1 lse", lse, plse, tol))}
    delta = fa.flash_attention_bwd_delta_cuda(o, do)
    err["flash_attention_bwd_delta"] = check(
        f"{tag} K2 delta", delta, far.flash_attention_bwd_delta_plain(o, do),
        1e-4 * max(1.0, float(delta.abs().max())))
    dq = fa.flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)
    pdq, pdk, pdv = far.flash_attention_bwd_plain(q, k, v, po, plse, do, **kw)
    torch.cuda.synchronize()
    for name, a, b in (("dq", dq, pdq), ("dk", dk, pdk), ("dv", dv, pdv)):
        if not torch.isfinite(a).all():
            raise AssertionError(f"{tag} K2 {name}: non-finite")
        if bf16:
            if rel_err(a, b) > FA_BF16_GRAD_REL:
                raise AssertionError(f"{tag} K2 {name}: {rel_err(a, b)} of max|ref| "
                                     f"> {FA_BF16_GRAD_REL}")
        else:
            torch.testing.assert_close(a, b, atol=FA_F32_GRAD_TOL, rtol=FA_F32_GRAD_TOL,
                                       msg=lambda m, n=name: f"{tag} K2 {n}: {m}")
    err["flash_attention_bwd_dq"] = max_err(dq, pdq)
    err["flash_attention_bwd_dkv"] = max(max_err(dk, pdk), max_err(dv, pdv))
    return err


def phase_train_kernels():
    from repro_torch.kernels.flash_attention import cuda as fa
    from repro_torch.kernels.flash_attention import ref as far
    from repro_torch.kernels.rmsnorm import cuda as rn
    from repro_torch.kernels.rmsnorm import ref as rnr

    f32, bf = torch.float32, torch.bfloat16
    cases = [(B, S, Kv, G, hd, causal, 0) for B, S, Kv, G, hd in FA_SHAPES
             for causal in (True, False)]
    cases += [(1, 256, 2, 2, 32, True, w) for w in (32, 128, 250)] + FA_CASES
    for i, (B, S, Kv, G, hd, causal, window) in enumerate(cases):
        fa_check(f"f32 {(B, S, Kv, G, hd, causal, window)}", *fa_flat(B, S, Kv, G, hd, f32, i),
                 dict(group=G, causal=causal, window=window), bf16=False)
    for rows, d in RN_SHAPES:
        for dt, tol in ((f32, FA_F32_TOL), (bf, RN_BF16_TOL)):
            x, g = (torch.tensor(np.random.RandomState(rows + d + j).randn(rows, d),
                                 dtype=f32).to("cuda", dt) for j in (0, 1))
            scale = (1 + 0.1 * torch.randn(d, generator=torch.Generator().manual_seed(d))).to("cuda")
            check(f"K3 {dt} {(rows, d)}", rn.rmsnorm_fwd_cuda(x, scale),
                  rnr.rmsnorm_plain(x, scale), tol)
            dx, ds = rn.rmsnorm_bwd_cuda(x, scale, g)
            pdx, pds = rnr.rmsnorm_bwd_plain(x, scale, g)
            check(f"K4 dx {dt} {(rows, d)}", dx, pdx, tol)
            check(f"K4 dscale {dt} {(rows, d)}", ds, pds, RN_DSCALE_TOL)
            if not torch.equal(ds, rn.rmsnorm_bwd_cuda(x, scale, g)[1]):
                raise AssertionError("K4 dscale differs between two runs")
    emit(phase="train_kernels_f32", cases=len(cases), fa_tol=FA_F32_TOL,
         fa_grad_tol=FA_F32_GRAD_TOL, rmsnorm_shapes=RN_SHAPES, dscale_deterministic=True)

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    results = {}
    fa_rows = [("gemma3-1b", s) for s in GEMMA_FA] + [("granite-8b", dict(GRANITE_FA, layers=0))]
    for model, s in fa_rows:
        B, S, Kv, G, hd, w = s["B"], s["S"], s["Kv"], s["G"], s["hd"], s["window"]
        q, k, v, do = fa_flat(B, S, Kv, G, hd, bf, seed=hd + w)
        kw = dict(group=G, causal=True, window=w)
        errs = fa_check(f"bf16 {model} w{w}", q, k, v, do, kw, bf16=True)
        o, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
        delta = fa.flash_attention_bwd_delta_cuda(o, do)
        kern = {
            "flash_attention_fwd": lambda: fa.flash_attention_fwd_cuda(q, k, v, **kw),
            "flash_attention_bwd_delta": lambda: fa.flash_attention_bwd_delta_cuda(o, do),
            "flash_attention_bwd_dq": lambda: fa.flash_attention_bwd_dq_cuda(
                q, k, v, do, lse, delta, **kw),
            "flash_attention_bwd_dkv": lambda: fa.flash_attention_bwd_dkv_cuda(
                q, k, v, do, lse, delta, **kw),
        }
        plain_fwd = time_ms(lambda: far.flash_attention_fwd_plain(q, k, v, **kw), flush,
                            warmup=2, reps=5)
        # the plain backward computes dq, dk and dv together (autograd)
        plain_bwd = time_ms(lambda: far.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw),
                            flush, warmup=2, reps=5)
        plain = {"flash_attention_fwd": plain_fwd,
                 "flash_attention_bwd_delta": time_ms(
                     lambda: far.flash_attention_bwd_delta_plain(o, do), flush),
                 "flash_attention_bwd_dq": plain_bwd, "flash_attention_bwd_dkv": plain_bwd}
        # library yardstick: SDPA with the kv heads expanded to the query heads
        qd = q.view(1, B * Kv * G, S, hd)
        kd, vd = (t.repeat_interleave(G, 0).view(1, B * Kv * G, S, hd) for t in (k, v))
        mask = None
        if w:
            from repro_torch.kernels.flash_attention.ref import visible_mask

            mask = visible_mask(S, S, causal=True, window=w, device="cuda")
        sdpa = dict(attn_mask=mask, is_causal=mask is None, scale=1.0)
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd, **sdpa), flush)
        qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (qd, kd, vd))
        out = F.scaled_dot_product_attention(qg, kg, vg, **sdpa)
        dod = do.view(1, B * Kv * G, S, hd)
        lib_bwd = time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), dod,
                                                      retain_graph=True), flush)
        bounds = fa_bounds(B, S, Kv, G, hd, w, 2)
        for name, fn in kern.items():
            nbytes, flops = bounds[name]
            bms, by = bound(nbytes, flops, bf)
            row = dict(model=model, kernel=name, shape=s, max_abs_err=errs[name],
                       kernel_ms=time_ms(fn, flush), plain_ms=plain[name],
                       library_ms=lib_fwd if name == "flash_attention_fwd" else lib_bwd,
                       bound_ms=bms, bound_by=by, bytes=nbytes, flops=flops)
            emit(phase="train_kernels_bf16", fwd_tol=BF16_TOL, grad_rel_tol=FA_BF16_GRAD_REL,
                 **row)
            results.setdefault(name, []).append(row)
        del out, qg, kg, vg
    # K3/K4 at the training path's (B*S, d_model) = (8192, 1152), and granite's width
    for rows, d in RN_SHAPES:
        x, g = (torch.tensor(np.random.RandomState(j).randn(rows, d), dtype=torch.float32)
                .to("cuda", bf) for j in (0, 1))
        scale = (1 + 0.1 * torch.randn(d, generator=torch.Generator().manual_seed(1))).to("cuda")
        dx, ds = rn.rmsnorm_bwd_cuda(x, scale, g)
        pdx, pds = rnr.rmsnorm_bwd_plain(x, scale, g)
        errs = {"rmsnorm_fwd": max_err(rn.rmsnorm_fwd_cuda(x, scale), rnr.rmsnorm_plain(x, scale)),
                "rmsnorm_bwd": max(max_err(dx, pdx), max_err(ds, pds))}
        wx = scale.to(bf)
        xg, wg = x.detach().clone().requires_grad_(True), wx.detach().clone().requires_grad_(True)
        out = F.rms_norm(xg, (d,), wg, eps=1e-6)
        io = rows * d * 2
        spec = {
            "rmsnorm_fwd": (lambda: rn.rmsnorm_fwd_cuda(x, scale),
                            lambda: rnr.rmsnorm_plain(x, scale),
                            lambda: F.rms_norm(x, (d,), wx, eps=1e-6),
                            2 * io + 4 * d, 4 * rows * d),
            "rmsnorm_bwd": (lambda: rn.rmsnorm_bwd_cuda(x, scale, g),
                            lambda: rnr.rmsnorm_bwd_plain(x, scale, g),
                            lambda: torch.autograd.grad(out, (xg, wg), g, retain_graph=True),
                            3 * io + 8 * d, 10 * rows * d),
        }
        for name, (kern, plain, lib, nbytes, flops) in spec.items():
            bms, by = bound(nbytes, flops, bf)
            row = dict(model="gemma3-1b" if d == 1152 else "granite-8b", kernel=name,
                       shape=dict(rows=rows, d=d), max_abs_err=errs[name],
                       kernel_ms=time_ms(kern, flush), plain_ms=time_ms(plain, flush),
                       library_ms=time_ms(lib, flush), bound_ms=bms, bound_by=by,
                       bytes=nbytes, flops=flops)
            emit(phase="train_kernels_bf16", tol=RN_BF16_TOL, **row)
            results.setdefault(name, []).append(row)
    return main_path_rows(results)


def main_path_rows(results):
    """One row per kernel at the training main path's shapes. K1/K2 run at
    two shapes there (4 global layers, 22 with window 512): their row is the
    mean per launch over one step's mix; K3/K4's is gemma3-1b's shape."""
    rows = {}
    for name, rs in results.items():
        gemma = [r for r in rs if r["model"] == "gemma3-1b"]
        if name.startswith("rmsnorm"):
            rows[name] = gemma[0]
            continue
        n = sum(r["shape"]["layers"] for r in gemma)
        mean = {k: sum(r[k] * r["shape"]["layers"] for r in gemma) / n
                for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
        by = max(gemma, key=lambda r: r["bound_ms"] * r["shape"]["layers"])["bound_by"]
        rows[name] = dict(mean, bound_by=by, max_abs_err=max(r["max_abs_err"] for r in gemma))
    return rows


def phase_train_parity() -> None:
    """Reduced gemma3-1b (6 layers, window 64 < seq 128), f32: three steps of
    fit on the card (kernels) against the same three on the CPU (plain)."""
    from repro_torch.configs import get_reduced
    from repro_torch.data import DataPipeline
    from repro_torch.launch.train import kernel_launches, reset_kernel_launches
    from repro_torch.models import init_params
    from repro_torch.optim import get as get_opt
    from repro_torch.train import TrainConfig, fit, make_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_reduced("gemma3-1b")
    tc = TrainConfig(precision="f32", lr=1e-4, log_every=1)
    runs = {}
    for dev in ("cpu", "cuda"):
        opt = get_opt(tc.optimizer, tc.lr)
        params = init_params(cfg, seed=7, device="cpu", dtype=torch.float32).to(dev)
        state = make_state(cfg, opt, tc, device=dev, params=params)
        data = DataPipeline(cfg, 2, 128, seed=0)
        reset_kernel_launches()
        try:
            state, hist = fit(cfg, tc, data, 3, opt, state=state, log=lambda line: None)
        finally:
            data.close()
        runs[dev] = (hist, [p.detach().float().cpu() for p in state["params"].parameters()],
                     kernel_launches())
    (h_cpu, p_cpu, _), (h_gpu, p_gpu, launches) = runs["cpu"], runs["cuda"]
    if min(launches.values()) <= 0:
        raise AssertionError(f"train-parity: a kernel was not launched: {launches}")
    worst = {"loss": 0.0, "grad_norm": 0.0, "params": 0.0}
    for a, b in zip(h_gpu, h_cpu):
        for key in ("loss", "grad_norm"):
            if not np.isfinite(a[key]):
                raise AssertionError(f"train-parity: non-finite {key} on the card")
            rel = abs(a[key] - b[key]) / abs(b[key])
            worst[key] = max(worst[key], rel)
    for a, b in zip(p_gpu, p_cpu):
        # per tensor, in norm: Adam moves an element whose gradient sits at
        # the roundoff level by up to lr either way, so single elements of
        # near-zero gradient may differ by more than 1e-3 of their value
        worst["params"] = max(worst["params"], float((a - b).norm() / b.norm()))
    if max(worst.values()) > 1e-3:
        raise AssertionError(f"train-parity: card vs CPU {worst} > rtol 1e-3")
    emit(phase="train_parity", config=cfg.name,
         allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32, steps=3, rtol=1e-3,
         max_rel_err=worst, losses_cuda=[h["loss"] for h in h_gpu],
         losses_cpu=[h["loss"] for h in h_cpu], launches=launches)


def phase_train():
    """launch/workload.py's gemma3-1b training workload at full width and
    depth: 10 steps of fit, bf16 over f32 masters, AdamW, the chunked-CE
    head, remat none."""
    from repro_torch.launch.train import kernel_launches, reset_kernel_launches
    from repro_torch.launch.workload import gemma_train_workload
    from repro_torch.optim import get as get_opt
    from repro_torch.train import fit, make_state

    wl = gemma_train_workload()
    cfg, tc = wl.cfg, wl.tc
    opt = get_opt(tc.optimizer, tc.lr)
    t0 = time.perf_counter()
    state = make_state(cfg, opt, tc, seed=wl.seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in state["params"].parameters())
    if (wl.batch, wl.seq) != (TRAIN_B, TRAIN_S):
        raise AssertionError(f"train workload {wl.batch} x {wl.seq} != the kernel "
                             f"phase's {TRAIN_B} x {TRAIN_S}")
    data = wl.data()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_launches()                 # counts of the main path only
    try:
        state, hist = fit(cfg, tc, data, TRAIN_STEPS, opt, state=state,
                          log=lambda line: None)
    finally:
        data.close()
    launches = kernel_launches()
    losses = [h["loss"] for h in hist]
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"train: losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: the loss did not fall: {losses}")
    L = cfg.n_layers
    per_step = {"flash_attention_fwd": L, "flash_attention_bwd_delta": L,
                "flash_attention_bwd_dq": L, "flash_attention_bwd_dkv": L,
                "rmsnorm_fwd": 2 * L + 1, "rmsnorm_bwd": 2 * L + 1}
    for name, n in per_step.items():
        if launches[name] != n * TRAIN_STEPS:
            raise AssertionError(f"train: {name} launched {launches[name]} times, "
                                 f"not {n} x {TRAIN_STEPS} steps")
    step_ms = statistics.median(h["step_s"] for h in hist[2:]) * 1e3
    emit(phase="train", config=cfg.name, params=n_params, dtype="bf16 over f32 masters",
         optimizer="adamw", lr=tc.lr, batch=TRAIN_B, seq=TRAIN_S, remat=tc.remat,
         head="chunked CE", steps=TRAIN_STEPS, params_init_s=init_s,
         median_step_ms=step_ms, tokens_per_s=TRAIN_B * TRAIN_S / (step_ms / 1e3),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         first_loss=losses[0], last_loss=losses[-1], losses=losses,
         step_ms=[h["step_s"] * 1e3 for h in hist], launches=launches,
         launches_per_step=per_step)
    del state
    torch.cuda.empty_cache()
    return launches


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
    from repro_torch.kernels.rmsnorm import cuda as rn
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
    rn.reset_launches()
    out = eng.run()
    launches = dict(cuda.LAUNCHES)
    k3 = rn.LAUNCHES["rmsnorm_fwd"]
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
    passes = chunks + launches["paged_decode_attention"] // L
    if k3 != passes * (2 * L + 1):         # two norms per layer and the final one
        raise AssertionError(f"K3 launches {k3} != {passes} passes x {2 * L + 1}")
    emit(phase="serve", config=cfg.name, dtype="bf16", params_init_s=init_s,
         requests=len(rids), new_tokens=new, num_pages=ecfg.num_pages,
         tokens_per_s=s["tokens_per_s"], run_mean_ttft_s=s["run_mean_ttft_s"],
         wall_s=s["wall_s"], prefill_chunks=chunks,
         decode_steps=launches["paged_decode_attention"] // L,
         launches=launches, rmsnorm_fwd_launches=k3,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
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
    kern.update(phase_train_kernels())
    phase_model()
    phase_train_parity()
    launches = phase_train()               # K1-K4: the training main path
    wl, params, rids, out, serve_launches = phase_serve()
    phase_alone(wl, params, rids, out)
    launches.update(serve_launches)        # K5, K6: the serving main path
    rows = []
    for name, (source, replaces) in KERNELS.items():
        r = kern[name]
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces,
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
