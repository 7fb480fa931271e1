"""Smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order (any failure exits nonzero and prints no result line):
  1. card    — the card's name and power limit from nvidia-smi;
  2. build   — nvcc builds every kernel source from the checkout, one nvcc per
               source, all started together; ptxas's registers and spills of
               the tensor-core flash-attention kernels per head dim, and of
               every RMSNorm and codec (K7, K8) kernel body, none of which may
               spill; with cuobjdump, each codec body's count of LDS, SHFL,
               MUFU, F2I, F2F, F2FP and PRMT instructions; the registers and
               spills of every K5/K6 instance over an int8 or fp8 pool;
  3. kernels — K5 (paged decode) and K6 (paged prefill) against their plain
               PyTorch versions, in f32 (atol/rtol 2e-5) and in bf16 (4e-3:
               both sides compute in f32 and round once to bf16): the JAX
               package's cases, multi-tile K6 chunks, decode lengths at and
               around a 64-key split boundary, K6 chunks off a page across a
               64-key tile and a 128-key split, windows 0, 6 and 64, the
               poisoned null page, K6 at T = 1 against K5, inactive slots
               (a read past the table would fault), and batched == alone
               bitwise; groups past 8 rows (recurrentgemma-2b's G 10 at hd
               256, granite-34b's G 48 at hd 128) across split edges, batched
               == alone; then bf16 at the serving path's shapes (and
               granite-34b's) with times, bounds and a library yardstick;
               then over int8 and fp8 pools (codes and f32 scales from
               kv_quantize), f32 q at 2e-5 and bf16 q at 4e-3: the same cases,
               a poisoned null page (NaN codes and scales) that must not leak,
               batched == alone bitwise, and timed at the serve workload's
               decode and 128-token prefill shapes beside the bf16 kernel;
               then at a 32,768-key table, where the split grid is capped
               (granite-8b's heads, one slot at ~32k keys beside short ones,
               windows 0, 1,000 and 4,096; pools at q's dtype and int8, f32
               and bf16 q): against the plain versions, batched == alone
               bitwise, and each call's workspace bytes beside the uncapped
               grid's;
  4. train kernels — K1 (flash forward), K2 (its delta, dq and dk/dv
               launches), K3 and K4 (RMSNorm forward, backward) against their
               plain versions: f32 on the JAX suites' shapes and hd 96
               (forward 2e-5, gradients 1e-4), bf16 on the same shapes and
               at gemma3-1b's training shapes, granite-8b's and
               phi-3-vision's (hd 96) (forward 4e-3, gradients 1% of
               max|ref|, dk and dv the same bits on two runs), with times,
               bounds and a library yardstick (for K2's delta, which no
               single call computes, a copy_ of the same bytes); K3/K4 in
               f32 (2e-5, dscale 1e-4) and bf16 (1e-2) at the training
               widths, at d that no
               16-byte vector divides, one row, idle row groups, d 7168 and
               12,288, the decode shape and views at an odd storage offset
               (both bodies), dscale the same bits on two runs, timed at the
               train, pipe and serving shapes;
  5. quant kernels — K8a / K8b (blockwise dynamic 8-bit quantize,
               dequantize) against their plain versions, bitwise (codes,
               scales, dequantized values): the JAX suite's sizes and scales,
               a zero input that needs padding, block absmaxes from the
               smallest subnormal to FLT_MAX, every midpoint and its f32
               neighbours times powers of two, +-0 blocks, every f32 in
               [-1, 1] (K8a, codes and scales), and every leaf size of the
               adam8bit main path on Adam-m-like and v-like inputs, with
               times and bounds there;
  6. stash kernels — K7a / K7b (the activation stash's symmetric int8 / fp8
               codec) against the plain version, bitwise, int8 / fp8 x f32 /
               bf16: the JAX suite's shapes, padding, zero blocks, values on
               int8 and fp8 rounding ties, every finite bf16 value under 100
               block absmaxes from bf16 subnormals to the largest finite bf16,
               and the pipe phase's slot, with times, bounds and ptxas
               registers and spills;
  7. model   — reduced granite-8b on the card (kernels) against the same
               model on the CPU (plain versions), f32, rtol 1e-3, with the
               pool at f32 and as int8 and fp8 codes (the share of codes that
               differ card vs CPU printed);
  8. train-parity — reduced gemma3-1b, f32 with TF32 off: three training
               steps on the card against the same steps on the CPU, rtol 1e-3,
               with AdamW, and with adam8bit and adam4bit on a 24-layer,
               width-192 variant whose stacked norm scales are quantized
               (K8 on the card, its plain version on the CPU);
  9. pipe-parity — reduced granite-8b (4 layers), f32 with TF32 off, P = 2,
               M = 4: three pipeline steps on the card against the same on
               the CPU, raw and int8 stash, rtol 1e-3, and the share of stash
               codes that differ card vs CPU;
 10. train   — gemma3-1b at full width and depth, bf16 over f32 masters,
               AdamW, batch 4 x seq 2048, 10 steps through train.loop.fit;
               launch counters read around this run only;
 11. train8  — the same with adam8bit (launch/workload.py's
               gemma_train8_workload): exact K1-K4 and K8 launch counts, the
               optimizer state's bytes against AdamW's;
 12. pipe    — launch/workload.py's granite_pipe_workload: granite-8b at full
               width, 8 layers, bf16 over f32 masters, batch 8 x seq 2048,
               P = 4 stages, M = 8, 1F1B, int8 stash, through
               build_train_pipeline_host: 2 warm-up and 3 timed steps; exact
               K1-K4 and K7 launch counts read around the timed steps, the
               stash report;
 13. pipe-host — the same workload with the raw and with the host stash
               (window 2, lookahead 2), 2 steps each: bitwise-equal losses,
               the overlap counters; the memory peak across
               pipeline_grads_host alone, over what was allocated before it,
               for raw, int8 (from pipe) and host: int8 and host at most raw,
               raw at most its grad accumulators, slots, wires and one
               backward op measured alone;
 14. serve   — launch/workload.py's granite-8b workload at full width and
               depth, bf16, random weights from a seed: 8 requests through
               ServeEngine (chunked prefill 128, 4 slots, page 16), launch
               counters read around this run only;
 15. alone   — 2 of the requests rerun alone in a fresh engine must give the
               same greedy tokens;
 16. serve-int8, serve-fp8 — the same workload with the pool as int8 / fp8
               codes (the same weights): exact launch counts of the quantized
               K5/K6 (the bf16 variants at 0) and K3, tokens/s, TTFT, pool
               bytes and peak memory; each followed by its alone phase.
The line before last lists every kernel as JSON; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import re
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

from repro_torch.launch import profile_codec as pcd  # noqa: E402
from repro_torch.launch import profile_rmsnorm as prn  # noqa: E402
from repro_torch.launch.timing import bound, time_ms  # noqa: E402

BF16_TOL = 4e-3                   # ~1 bf16 ulp at |out| ~1; outputs here are < 1
PA_SOURCE = "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu"
FA_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
RN_SOURCE = "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu"
BQ_SOURCE = "src/repro_torch/kernels/blockwise_quant/csrc/blockwise_quant.cu"
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
    "blockwise_quantize": (BQ_SOURCE, "src/repro/kernels/blockwise_quant/kernel.py:56"),
    "blockwise_dequantize": (BQ_SOURCE, "src/repro/kernels/blockwise_quant/kernel.py:87"),
    "stash_quantize": (BQ_SOURCE, "src/repro/kernels/blockwise_quant/kernel.py:147"),
    "stash_dequantize": (BQ_SOURCE, "src/repro/kernels/blockwise_quant/kernel.py:181"),
    # over int8 / fp8 pools: the same TPU kernels with their k_scale / v_scale
    "paged_decode_attention_int8": (PA_SOURCE, "src/repro/kernels/paged_attention/kernel.py:262"),
    "paged_decode_attention_fp8": (PA_SOURCE, "src/repro/kernels/paged_attention/kernel.py:262"),
    "paged_prefill_attention_int8": (PA_SOURCE,
                                     "src/repro/kernels/paged_attention/kernel.py:195"),
    "paged_prefill_attention_fp8": (PA_SOURCE, "src/repro/kernels/paged_attention/kernel.py:195"),
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
# K6 chunks of T*G > 32 rows at nonzero starts (more than one 32-row tile
# of the first CUDA design), and of more than one 64-row tile of the
# tensor-core kernel: T 24 x G 3 puts a tile edge inside a position's rows.
MULTI_TILE_CASES = [
    (2, 16, 2, 4, 32, 4, 16, 8, [5, 13], [16, 11]),
    (1, 12, 1, 3, 64, 8, 8, 4, [9], [12]),
    (1, 16, 2, 4, 128, 16, 8, 6, [40], [16]),
    (1, 24, 1, 3, 64, 8, 16, 6, [9], [24]),
    (2, 32, 2, 4, 128, 16, 16, 8, [5, 40], [32, 25]),
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


def visible_keys(qpos: int, window: int) -> int:
    n = qpos + 1
    return min(n, window) if window > 0 else n


def extent_bytes(lo_pos: int, end_tok: int, page: int, Kv: int, row_bytes: int,
                 window: int) -> int:
    """Least bytes of K, V and block table that rows at positions lo_pos ..
    end_tok-1 need: the K/V rows (``row_bytes`` each, per kv head) from the
    lowest row's window start (0 without a window) to end_tok, and the table
    entries of their pages."""
    first = max(0, lo_pos - window + 1) if window > 0 else 0
    if end_tok <= first:
        return 0
    entries = (end_tok - 1) // page - first // page + 1
    return 2 * (end_tok - first) * Kv * row_bytes + 4 * entries


def pool_row_bytes(kp, hd: int) -> int:
    """Bytes of one cached (key, kv head) row of a pool: hd elements, and a
    quantized pool's 4-byte scale beside its hd 1-byte codes."""
    return hd * kp.element_size() + (4 if kp.element_size() == 1 else 0)


def decode_bound(q, kp, tables, lengths, window):
    B, Kv, G, hd = q.shape
    page = kp.shape[1]
    isz = q.element_size()
    nbytes = 2 * q.numel() * isz + lengths.numel() * 4      # q in, out, lengths
    flops = 0
    for L in lengths.tolist():
        nbytes += extent_bytes(L - 1, L, page, Kv, pool_row_bytes(kp, hd), window)
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
        nbytes += extent_bytes(s, s + n, page, Kv, pool_row_bytes(kp, hd), window)
        flops += sum(4 * hd * G * Kv * visible_keys(s + t, window) for t in range(n))
    return nbytes, flops



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
    from repro_torch.kernels.blockwise_quant import cuda as bq
    from repro_torch.kernels.flash_attention import cuda as fa
    from repro_torch.kernels.paged_attention import cuda as pa
    from repro_torch.kernels.rmsnorm import cuda as rn

    t0 = time.perf_counter()
    mods = (pa, fa, rn, bq)
    with ThreadPoolExecutor(len(mods)) as ex:       # one nvcc per source, together
        list(ex.map(lambda m: m.library(), mods))
    ptxas = {}
    for m in mods:
        log = build.library_path(m.SOURCE).with_suffix(".log").read_text().splitlines()
        regs = [int(ln.split("Used ")[1].split()[0]) for ln in log if "registers" in ln]
        spills = [ln.strip() for ln in log if "spill" in ln and not ln.strip().startswith("0 bytes")]
        ptxas[m.SOURCE] = dict(kernels=len(regs), max_registers=max(regs), spills=spills)
    fa_mma = {}
    for name, r in ptxas_of(fa.SOURCE, "_mma_kernel").items():
        kern, hd = re.search(r"(fa_\w+?_mma_kernel)ILi(\d+)E", name).groups()
        fa_mma[f"{kern}<{hd}>"] = r
    rn_ptxas = {}
    for name, r in ptxas_of(rn.SOURCE, "rmsnorm_").items():
        m = re.search(r"(rmsnorm_\w+?_kernel)(?:I(13__nv_bfloat16|f)Li(\d+)ELi(\d+)E)?", name)
        kern, t, vec, nv = m.groups()
        key = kern if t is None else f"{kern}<{'bf16' if t != 'f' else 'f32'},{vec},{nv}>"
        rn_ptxas[key] = r
    codec_ptxas = {codec_body(name): r for name, r in ptxas_of(bq.SOURCE, "quantize_kernel").items()}
    spilled = {k: r["spills"] for k, r in {**rn_ptxas, **codec_ptxas}.items()
               if not r.get("spills", "").startswith("0 bytes stack frame, 0 bytes spill stores")}
    if spilled:
        raise AssertionError(f"rmsnorm.cu or blockwise_quant.cu kernels spill: {spilled}")
    sass = sass_counts(bq.SOURCE, "quantize_kernel")
    emit(phase="build", seconds=round(time.perf_counter() - t0, 3), ptxas=ptxas,
         flash_attention_mma_ptxas=fa_mma, rmsnorm_ptxas=rn_ptxas, codec_ptxas=codec_ptxas,
         codec_sass=None if sass is None else {codec_body(k): v for k, v in sass.items()},
         paged_quant_ptxas=paged_quant_ptxas(pa.SOURCE))


def paged_quant_ptxas(source: str) -> dict:
    """Registers and spills of every paged-attention kernel instance over an
    int8 or fp8 pool, keyed by its demangled template name (cu++filt)."""
    from repro_torch.kernels import build

    found = ptxas_of(source, "paged_")
    tool = Path(build.nvcc_path()).with_name("cu++filt")
    names = list(found)
    if tool.exists():
        names = subprocess.run([str(tool)], input="\n".join(names), check=True,
                               capture_output=True, text=True, timeout=60).stdout.splitlines()
    out = {}
    for mangled, name in zip(found, names):
        short = re.sub(r"^.*::(paged_\w+<[^>]*>).*$", r"\1", name)
        if re.search(r"signed char|fp8_e4m3|(?:f|bfloat16)aLi|Li\d+EaE", short):
            out[short] = found[mangled]
    return out


def codec_body(mangled: str) -> str:
    """``stash_quantize_kernel<1,0>`` (template flags as 0/1) from a mangled
    name of blockwise_quant.cu."""
    m = re.search(r"(\w*quantize_kernel)(?:I((?:Lb[01]E)+)E)?", mangled)
    flags = ",".join(re.findall(r"Lb([01])E", m.group(2) or ""))
    return f"{m.group(1)}<{flags}>" if flags else m.group(1)


SASS_OPS = ("LDS", "SHFL", "MUFU", "F2I", "F2F", "F2FP", "PRMT")


def sass_counts(source: str, key: str):
    """For each entry function of ``source`` whose mangled name holds
    ``key``, the number of SASS instructions of each ``SASS_OPS`` kind, from
    ``cuobjdump -sass``; None where the toolkit has no cuobjdump."""
    from repro_torch.kernels import build

    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    if not tool.exists():
        return None
    text = subprocess.run([str(tool), "-sass", str(build.library_path(source))], check=True,
                          capture_output=True, text=True, timeout=120).stdout
    out, name = {}, None
    for ln in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", ln)
        if head:
            name = head.group(1) if key in head.group(1) else None
            if name:
                out[name] = dict.fromkeys(SASS_OPS, 0)
            continue
        op = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?\w+\s+)?([A-Z0-9]+)", ln)
        if name and op and op.group(1) in out[name]:
            out[name][op.group(1)] += 1
    return out


# K5 decode lengths at a split boundary (cuda.DECODE_SPLIT = 64 keys), one
# token either side of it, at one token, and across two boundaries; page 16
EDGE_DECODE = (6, 2, 4, 128, 16, 40, 16, [64, 63, 65, 1, 128, 129])
# K6 chunks whose start is not page-aligned: across a 64-key tile (57..72),
# and across a 256-key bf16 split (250..265); q_len ragged in the second
EDGE_PREFILL = (2, 16, 2, 4, 128, 16, 40, 20, [57, 250], [16, 11])
# batched == alone: slots of other lengths / starts around each other
ALONE_DECODE = (4, 2, 4, 128, 16, 60, 16, [200, 37, 129, 64])
ALONE_PREFILL = (3, 32, 2, 4, 128, 16, 60, 24, [0, 100, 250], [32, 17, 30])
# groups of more than 8 query rows a kv head: recurrentgemma-2b's G 10 at hd
# 256 and granite-34b's G 48 at hd 128 (Kv 1). K5 and f32 K6 take them in
# chunks of 8 rows; bf16 K6 flattens (t, g) into 64-row tiles, whose edges
# fall inside a position's rows. Decode lengths across the 64-key split
# edge; chunks across a 64-key (f32) and a 128-key (bf16) split edge.
LARGE_G_DECODE = [(3, 1, 10, 256, 16, 24, 16, [64, 65, 200]),
                  (2, 1, 48, 128, 16, 16, 16, [63, 129])]
LARGE_G_PREFILL = [(2, 16, 1, 10, 256, 16, 16, 16, [57, 120], [16, 11]),
                   (2, 8, 1, 48, 128, 16, 24, 20, [60, 250], [8, 8])]


def inactive_decode_case(dtype):
    """Two active slots and two inactive ones, as the engine leaves them: a
    zeroed table row at length 1, and a table row at a length past its P *
    page keys. The tables are the first B*P entries of a buffer whose next
    entry names a page far past the pool, so a read of entry P of the last
    row faults (a synchronize reports it)."""
    B, Kv, G, hd, page, N, P = 4, 2, 4, 128, 16, 24, 6
    q, kp, vp, tables, _ = make_decode_case(B, Kv, G, hd, page, N, P, [70, 33, 1, 1],
                                            dtype, seed=21)
    buf = torch.full((B * P + 1,), 1 << 28, dtype=torch.int32, device="cuda")
    buf[:B * P] = tables.flatten()
    tables = buf[:B * P].view(B, P)
    tables[2] = 0
    tables[3] = torch.arange(N - P, N, dtype=torch.int32, device="cuda")
    lengths = torch.tensor([70, 33, 1, P * page + 9], dtype=torch.int32, device="cuda")
    return q, kp, vp, tables, lengths


def assert_batched_equals_alone(name, fn, args, qlens=None):
    """fn on the batch == fn on each slot alone (its own table row), bitwise."""
    q, kp, vp, tables, *ints = args
    out = fn(*args)
    for b in range(q.shape[0]):
        alone = fn(q[b:b + 1].contiguous(), kp, vp, tables[b:b + 1].contiguous(),
                   *[t[b:b + 1].contiguous() for t in ints])
        rows = slice(None) if qlens is None else slice(0, int(qlens[b]))
        if not torch.equal(out[b:b + 1, rows], alone[:, rows]):
            raise AssertionError(f"{name}: slot {b} batched != alone")


def paged_case_checks(tag, prep, tol, poison) -> int:
    """Every K5/K6 case of the kernels phases: each made in f32 and turned by
    ``prep`` (f32 args -> (args, scale keywords): q and pools in the dtype
    under test, or q over code pools with their scales), each kernel held
    against its plain version at ``tol`` — the JAX package's cases at
    windows 0, 6 and 64 and the edges of the splits, a null page filled by
    ``poison(args, scales)`` that must not leak, K6 at T = 1 against K5,
    inactive slots, groups past 8 rows — and batched == alone bitwise.
    Returns the count of cases checked against the plain version."""
    from repro_torch.kernels.paged_attention import cuda, ref

    dec, pre = cuda.paged_decode_attention_cuda, cuda.paged_prefill_attention_cuda
    f32 = torch.float32
    n_checked = 0

    def decode(name, f32_args, window=0):
        args, sc = prep(f32_args)
        check(name, dec(*args, window=window, **sc),
              ref.paged_attention_plain(*args, window=window, **sc), tol)

    def prefill(name, f32_args, window=0):
        args, sc = prep(f32_args)
        check(name, pre(*args, window=window, **sc),
              ref.paged_prefill_attention_plain(*args, window=window, **sc), tol, args[5])

    def alone(name, op, f32_args, window=0, chunk=False):
        args, sc = prep(f32_args)
        assert_batched_equals_alone(name, lambda *a: op(*a, window=window, **sc), args,
                                    args[5].tolist() if chunk else None)

    # the JAX package's cases, windows 0 and 6, and the edges of the splits
    for case in DECODE_CASES + [EDGE_DECODE]:
        for window in (0, 6, 64):
            decode(f"K5 {tag} {case[:4]} {case[-1]} w{window}", make_decode_case(*case, f32),
                   window)
            n_checked += 1
    for case in PREFILL_CASES + MULTI_TILE_CASES + [EDGE_PREFILL]:
        for window in (0, 6, 64):
            prefill(f"K6 {tag} {case[:4]} {case[-2]} w{window}", make_prefill_case(*case, f32),
                    window)
            n_checked += 1
    # a poisoned null page never leaks into valid rows
    args, sc = prep(make_decode_case(2, 2, 2, 16, 8, 16, 4, [9, 12], f32, seed=1))
    clean = ref.paged_attention_plain(*args, **sc)
    poison(args, sc)
    check(f"K5 {tag} poisoned null page", dec(*args, **sc), clean, tol)
    args, sc = prep(make_prefill_case(2, 4, 2, 2, 32, 8, 16, 4, [3, 11], [4, 2], f32, seed=3))
    clean = ref.paged_prefill_attention_plain(*args, **sc)
    poison(args, sc)
    check(f"K6 {tag} poisoned null page", pre(*args, **sc), clean, tol, args[5])
    # T=1 prefill == decode at length start + 1
    args, sc = prep(make_prefill_case(2, 1, 2, 2, 16, 8, 16, 4, [6, 11], [1, 1], f32, seed=7))
    q, kp, vp, tb, st, ql = args
    check(f"K6 {tag} T=1 vs K5", pre(*args, **sc)[:, 0],
          dec(q[:, 0].contiguous(), kp, vp, tb, st + 1, **sc), tol)
    # inactive slots stay in bounds and finite; every row holds the plain
    decode(f"K5 {tag} inactive slots", inactive_decode_case(f32))
    n_checked += 4
    # batched == alone, bitwise
    for window in (0, 64):
        alone(f"K5 {tag} w{window}", dec, make_decode_case(*ALONE_DECODE, f32, seed=31), window)
        alone(f"K6 {tag} w{window}", pre, make_prefill_case(*ALONE_PREFILL, f32, seed=32),
              window, chunk=True)
    # any G, and batched == alone there
    for case in LARGE_G_DECODE:
        for window in (0, 64):
            decode(f"K5 {tag} G{case[2]} hd{case[3]} w{window}",
                   make_decode_case(*case, f32, seed=41), window)
            n_checked += 1
        alone(f"K5 {tag} G{case[2]}", dec, make_decode_case(*case, f32, seed=42))
    for case in LARGE_G_PREFILL:
        for window in (0, 64):
            prefill(f"K6 {tag} G{case[3]} hd{case[4]} w{window}",
                    make_prefill_case(*case, f32, seed=43), window)
            n_checked += 1
        alone(f"K6 {tag} G{case[3]}", pre, make_prefill_case(*case, f32, seed=44), chunk=True)
    torch.cuda.synchronize()
    return n_checked


def as_dtype(dtype):
    """``paged_case_checks``' prep for q and pools in ``dtype``."""
    return lambda args: ([a.to(dtype) if a.is_floating_point() else a for a in args], {})


def poison_large(args, scales):
    """1e3 / -1e3 in the null page of a pool at q's dtype."""
    args[1][0], args[2][0] = 1e3, -1e3


def phase_kernels():
    from repro_torch.kernels.paged_attention import cuda, ref

    dec, pre = cuda.paged_decode_attention_cuda, cuda.paged_prefill_attention_cuda
    f32, bf = torch.float32, torch.bfloat16
    for dtype, tol in ((f32, 2e-5), (bf, BF16_TOL)):
        tag = "f32" if dtype == f32 else "bf16"
        n_checked = paged_case_checks(tag, as_dtype(dtype), tol, poison_large)
        emit(phase="kernels_cases", dtype=tag, cases=n_checked, tol=tol,
             batched_equals_alone=4 + len(LARGE_G_DECODE) + len(LARGE_G_PREFILL),
             large_groups=[c[2] for c in LARGE_G_DECODE])

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
        # 48 query heads over one kv head: K5 in 6 row chunks, K6 in 96 row tiles
        ("granite-34b", "decode", dict(B=4, Kv=1, G=48, hd=128, page=16, P=40,
                                       lengths=[561, 590, 600, 633], window=0)),
        ("granite-34b", "prefill", dict(B=1, T=128, Kv=1, G=48, hd=128, page=16, P=40,
                                        starts=[384], qlens=[128], window=0)),
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
            S = cuda.n_splits(cuda.DECODE_SPLIT, s["page"], s["P"], cuda.DECODE_MAX_SPLITS)
            s["split_blocks_with_work"] = s["Kv"] * sum(
                cuda.splits_of(*cuda.decode_keys(L, w, s["page"], s["P"]), cuda.DECODE_SPLIT,
                               cuda.DECODE_MAX_SPLITS, S).count for L in s["lengths"])
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


# ------------------------------------------------ quantized K5 / K6 (codes)
QUANT_STORAGE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def quantize_case(args, storage, dtype):
    """An f32 case (q, kp, vp, tables, *ints) as q in ``dtype`` over pools of
    ``storage`` codes: (args, scales), the codes and scales of each pool row
    from the port's kv_quantize (what the engine writes)."""
    from repro_torch.kernels.paged_attention import quant

    q, kp, vp, tables, *ints = args
    kc, ks = quant.kv_quantize(kp, storage)
    vc, vs = quant.kv_quantize(vp, storage)
    return (q.to(dtype), kc, vc, tables, *ints), dict(k_scale=ks, v_scale=vs)


def poison_codes(args, scales):
    """Page 0 as garbage a quantized pool could hold: NaN codes (fp8's 0x7f;
    int8 has none: its extremes) and NaN scales."""
    kc, vc = args[1], args[2]
    if kc.dtype == torch.int8:
        kc[0], vc[0] = 127, -128
    else:
        kc[0].view(torch.uint8).fill_(0x7F)
        vc[0].view(torch.uint8).fill_(0xFF)
    scales["k_scale"][0], scales["v_scale"][0] = float("nan"), float("nan")


def phase_kernels_quant():
    """Quantized K5 and K6 (int8 / fp8 pools with their f32 scales) against
    the plain versions on the same codes and scales: f32 q at 2e-5 and bf16 q
    at BF16_TOL, every case of phase_kernels with a null page poisoned by NaN
    codes and scales, batched == alone bitwise; then timed at the serve
    workload's shapes beside the bf16 kernel. Returns one row per variant."""
    from repro_torch.kernels.paged_attention import cuda, ref

    dec, pre = cuda.paged_decode_attention_cuda, cuda.paged_prefill_attention_cuda
    f32, bf = torch.float32, torch.bfloat16
    for sname, storage in QUANT_STORAGE.items():
        for dtype, tol in ((f32, 2e-5), (bf, BF16_TOL)):
            tag = f"{sname} {'f32' if dtype == f32 else 'bf16'}"
            n_checked = paged_case_checks(
                tag, lambda a, st=storage, dt=dtype: quantize_case(a, st, dt), tol,
                poison_codes)
            emit(phase="kernels_quant_cases", pool=sname, q_dtype=str(dtype).split(".")[1],
                 cases=n_checked, tol=tol, poisoned_null_page=True,
                 batched_equals_alone=4 + len(LARGE_G_DECODE) + len(LARGE_G_PREFILL))

    # timed at the serve workload's decode and 128-token prefill shapes, bf16 q,
    # beside the bf16 kernel on the same values
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    s = QUANT_TIMED
    results = {}
    for kind in ("decode", "prefill"):
        if kind == "decode":
            N = 1 + sum(-(-L // s["page"]) for L in s["lengths"])
            base = make_decode_case(s["B"], s["Kv"], s["G"], s["hd"], s["page"], N, s["P"],
                                    s["lengths"], f32, seed=11)
            op, plain_op, name = dec, ref.paged_attention_plain, "paged_decode_attention"
            bound_of = lambda a: decode_bound(a[0], a[1], a[3], a[4], 0)  # noqa: E731
            qlens = None
        else:
            N = 1 + -(-(s["start"] + s["T"]) // s["page"])
            base = make_prefill_case(1, s["T"], s["Kv"], s["G"], s["hd"], s["page"], N, s["P"],
                                     [s["start"]], [s["T"]], f32, seed=12)
            op, plain_op, name = pre, ref.paged_prefill_attention_plain, "paged_prefill_attention"
            bound_of = lambda a: prefill_bound(a[0], a[1], a[3], a[4], a[5], 0)  # noqa: E731
            qlens = base[5]
        native = [t.to(bf) if t.is_floating_point() else t for t in base]
        bf16_ms = time_ms(lambda: op(*native), flush)
        for sname, storage in QUANT_STORAGE.items():
            args, sc = quantize_case(base, storage, bf)
            kern = lambda a=args, sc=sc: op(*a, **sc)                 # noqa: E731
            plain = lambda a=args, sc=sc: plain_op(*a, **sc)         # noqa: E731
            err = check(f"{name} {sname} bf16 granite-8b", kern(), plain(), BF16_TOL, qlens)
            nbytes, flops = bound_of(args)
            bms, by = bound(nbytes, flops, bf)
            row = dict(model="granite-8b", kernel=f"{name}_{sname}", shape=s, kind=kind,
                       max_abs_err=err, kernel_ms=time_ms(kern, flush),
                       plain_ms=time_ms(plain, flush), library_ms=None,
                       library="none: no single PyTorch call dequantizes and attends",
                       bf16_kernel_ms=bf16_ms, bound_ms=bms, bound_by=by, bytes=nbytes,
                       flops=flops)
            emit(phase="kernels_quant", tol=BF16_TOL, **row)
            results[row["kernel"]] = row
    return results


# the serve workload's shapes (launch/workload.py): 4 slots decoding at
# lengths 561-633 and one 128-token chunk at 384, granite-8b's Kv 8, G 4, hd 128
QUANT_TIMED = dict(B=4, Kv=8, G=4, hd=128, page=16, P=40, lengths=[561, 590, 600, 633],
                   T=128, start=384)


# ------------------------------------------ K5 / K6 at a 32,768-key table
# granite-8b's heads (Kv 8, G 4, hd 128) over a table of P 2,048 pages of 16,
# where the split grid is capped (cuda.DECODE_MAX_SPLITS, PREFILL_MAX_SPLITS):
# one slot at ~32k keys beside short ones. Decode: the long slot and 2,100
# keys (33 splits of 64) take longer ranges, 600 and 65 keep the fixed
# plan. Prefill: the long chunk's row tiles take 16 ranges of 2,048 keys;
# the chunk at 2,000 has positions on both sides of the cap (f32 q) and
# row tiles past it (bf16 q). Window 1,000 puts short rows' ranges in
# columns below their own split (the grid holds 32); window 4,096 gives the
# long slot 65 splits of 64.
LONG = dict(Kv=8, G=4, hd=128, page=16, P=2048, lengths=[32_700, 2_100, 600, 65],
            T=128, starts=[32_640, 2_000, 200], qlens=[128, 77, 128], windows=(0, 1000, 4096))


def phase_kernels_long():
    """K5 and K6 at LONG's 32,768-key table against their plain versions
    (f32 q 2e-5, bf16 q BF16_TOL) over pools at q's dtype and int8 pools,
    batched == alone bitwise at each window; prints each call's workspace
    bytes beside the uncapped grid's, and each decode slot's plan."""
    from repro_torch.kernels.paged_attention import cuda, ref

    dec, pre = cuda.paged_decode_attention_cuda, cuda.paged_prefill_attention_cuda
    f32, bf = torch.float32, torch.bfloat16
    s = LONG
    Kv, G, hd, page, P = s["Kv"], s["G"], s["hd"], s["page"], s["P"]
    B, Bp = len(s["lengths"]), len(s["starts"])
    N = 1 + sum(-(-L // page) for L in s["lengths"])
    dcase = make_decode_case(B, Kv, G, hd, page, N, P, s["lengths"], f32, seed=51)
    Np = 1 + sum(-(-(st + s["T"]) // page) for st in s["starts"])
    pcase = make_prefill_case(Bp, s["T"], Kv, G, hd, page, Np, P, s["starts"], s["qlens"],
                              f32, seed=52)
    preps = [("f32", as_dtype(f32), 2e-5), ("bf16", as_dtype(bf), BF16_TOL),
             ("int8 f32", lambda a: quantize_case(a, torch.int8, f32), 2e-5),
             ("int8 bf16", lambda a: quantize_case(a, torch.int8, bf), BF16_TOL)]
    n_checked = 0
    for tag, prep, tol in preps:
        dargs, dsc = prep(dcase)
        pargs, psc = prep(pcase)
        for w in s["windows"]:
            check(f"K5 long {tag} w{w}", dec(*dargs, window=w, **dsc),
                  ref.paged_attention_plain(*dargs, window=w, **dsc), tol)
            check(f"K6 long {tag} w{w}", pre(*pargs, window=w, **psc),
                  ref.paged_prefill_attention_plain(*pargs, window=w, **psc), tol, pargs[5])
            assert_batched_equals_alone(f"K5 long {tag} w{w}",
                                        lambda *a, w=w: dec(*a, window=w, **dsc), dargs)
            assert_batched_equals_alone(f"K6 long {tag} w{w}",
                                        lambda *a, w=w: pre(*a, window=w, **psc), pargs,
                                        s["qlens"])
            n_checked += 2
        del dargs, pargs, dsc, psc
        torch.cuda.empty_cache()
    workspace = {}
    for name, rows, split, cap in (
            ("K5", B * Kv * G, cuda.DECODE_SPLIT, cuda.DECODE_MAX_SPLITS),
            ("K6 bf16 q", Bp * s["T"] * Kv * G, cuda.PREFILL_SPLIT, cuda.PREFILL_MAX_SPLITS),
            ("K6 f32 q", Bp * s["T"] * Kv * G, cuda.DECODE_SPLIT, cuda.DECODE_MAX_SPLITS)):
        S, S_table = cuda.n_splits(split, page, P, cap), -(-P * page // split)
        workspace[name] = dict(rows=rows, S=S, bytes=4 * cuda.workspace_floats(rows, S, hd),
                               uncapped_S=S_table,
                               uncapped_bytes=4 * cuda.workspace_floats(rows, S_table, hd))
    S = cuda.n_splits(cuda.DECODE_SPLIT, page, P, cuda.DECODE_MAX_SPLITS)
    plans = {w: [cuda.splits_of(*cuda.decode_keys(L, w, page, P), cuda.DECODE_SPLIT,
                                cuda.DECODE_MAX_SPLITS, S)._asdict() for L in s["lengths"]]
             for w in s["windows"]}
    emit(phase="kernels_long", keys=P * page, shape=s, cases=n_checked,
         batched_equals_alone=n_checked, tols={"f32 q": 2e-5, "bf16 q": BF16_TOL},
         workspace=workspace, decode_plans=plans)


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
# hd 96 (phi-3-vision's head size): causal ragged S, and a window without
# the causal mask
FA_HD96_CASES = [(1, 200, 2, 2, 96, True, 0), (1, 160, 1, 3, 96, False, 48)]
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
PHI3V_FA = dict(B=1, S=2048, Kv=32, G=1, hd=96, window=0)   # phi-3-vision's heads
RN_SHAPES = [(TRAIN_B * TRAIN_S, 1152), (TRAIN_B * TRAIN_S, 4096)]
# K3/K4 beyond the training shapes, f32 and bf16: d that no 16-byte vector
# divides (100 in bf16, 1001, 7: the scalar body), a predicated last sweep
# (1000 in bf16), one row, row groups left without a row (601 rows of 64 on
# 605 groups), arctic-480b's 7168, the widest row 12,288, serving's decode
# and 128-token prefill chunk, the pipe's microbatch
RN_CASES = [(7, 100), (33, 1000), (5, 1001), (3, 7), (1, 1152), (601, 64),
            (5, 7168), (3, 12_288), (4, 4096), (128, 4096), (2048, 4096)]
# views at an odd storage offset (the scalar body): x and g, or scale alone
RN_OFFSET_CASES = [(64, 1152, 1, 0), (4, 4096, 1, 0), (64, 1152, 0, 1)]


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
    inputs; in bf16 also dk and dv against a second run, bitwise. Returns
    the max abs error of each kernel and, under "grad_rel", each gradient's
    max error over max|ref|."""
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
    if bf16:        # no atomics: the same bits on every run
        dk2, dv2 = fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)
        if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
            raise AssertionError(f"{tag} K2 dk/dv differ between two runs")
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
    err["grad_rel"] = {n: rel_err(a, b) for n, a, b in
                       (("dq", dq, pdq), ("dk", dk, pdk), ("dv", dv, pdv))}
    return err


def rmsnorm_inputs(rows, d, dtype, seed, x_offset=0, scale_offset=0):
    """x, g (rows, d) of ``dtype`` and scale (d,) f32 on the card, from
    numpy; an offset puts the tensor at that many elements into its buffer."""
    rng = np.random.RandomState(seed)

    def at(a, dt, offset):
        buf = torch.empty(a.size + offset, dtype=dt, device="cuda")
        buf[offset:] = torch.tensor(a.reshape(-1), dtype=torch.float32).to("cuda", dt)
        return buf[offset:].view(a.shape)

    x, g = (at(rng.randn(rows, d), dtype, x_offset) for _ in range(2))
    return x, g, at(1 + 0.1 * rng.randn(d), torch.float32, scale_offset)


def rmsnorm_check() -> dict:
    """K3 and K4 against their plain versions at RN_SHAPES, RN_CASES and
    RN_OFFSET_CASES, f32 and bf16; dscale the same bits on two runs. Returns
    how many cases each body (cuda.plan's vector or scalar) ran."""
    from repro_torch.kernels.rmsnorm import cuda as rn
    from repro_torch.kernels.rmsnorm import ref as rnr

    cases = [(rows, d, 0, 0) for rows, d in RN_SHAPES + RN_CASES] + RN_OFFSET_CASES
    bodies = {"vector": 0, "scalar": 0}
    for i, (rows, d, xo, so) in enumerate(cases):
        for dt, tol in ((torch.float32, FA_F32_TOL), (torch.bfloat16, RN_BF16_TOL)):
            x, g, scale = rmsnorm_inputs(rows, d, dt, seed=i, x_offset=xo, scale_offset=so)
            aligned = all(t.data_ptr() % 16 == 0 for t in (x, g, scale))
            if aligned != (xo == so == 0):
                raise AssertionError(f"K3/K4 case {(rows, d, xo, so)}: alignment {aligned}")
            body = rn.plan(rows, d, x.element_size(), aligned).body
            bodies[body] += 1
            tag = f"{dt} {(rows, d)} offsets {(xo, so)} {body}"
            check(f"K3 {tag}", rn.rmsnorm_fwd_cuda(x, scale), rnr.rmsnorm_plain(x, scale), tol)
            dx, ds = rn.rmsnorm_bwd_cuda(x, scale, g)
            pdx, pds = rnr.rmsnorm_bwd_plain(x, scale, g)
            check(f"K4 dx {tag}", dx, pdx, tol)
            check(f"K4 dscale {tag}", ds, pds, RN_DSCALE_TOL)
            if not torch.equal(ds, rn.rmsnorm_bwd_cuda(x, scale, g)[1]):
                raise AssertionError(f"K4 {tag}: dscale differs between two runs")
    return bodies


def phase_train_kernels():
    from repro_torch.kernels.flash_attention import cuda as fa
    from repro_torch.kernels.flash_attention import ref as far
    from repro_torch.kernels.rmsnorm import cuda as rn
    from repro_torch.kernels.rmsnorm import ref as rnr

    f32, bf = torch.float32, torch.bfloat16
    cases = [(B, S, Kv, G, hd, causal, 0) for B, S, Kv, G, hd in FA_SHAPES
             for causal in (True, False)]
    cases += [(1, 256, 2, 2, 32, True, w) for w in (32, 128, 250)] + FA_CASES + FA_HD96_CASES
    worst_rel = 0.0
    for dt in (f32, bf):
        for i, (B, S, Kv, G, hd, causal, window) in enumerate(cases):
            errs = fa_check(f"{dt} {(B, S, Kv, G, hd, causal, window)}",
                            *fa_flat(B, S, Kv, G, hd, dt, i),
                            dict(group=G, causal=causal, window=window), bf16=dt == bf)
            if dt == bf:
                worst_rel = max(worst_rel, *errs["grad_rel"].values())
    bodies = rmsnorm_check()
    emit(phase="train_kernels_f32", cases=len(cases), fa_tol=FA_F32_TOL,
         fa_grad_tol=FA_F32_GRAD_TOL, fa_bf16_cases=len(cases), fa_bf16_tol=BF16_TOL,
         fa_bf16_worst_grad_rel=worst_rel, fa_bf16_grad_rel_tol=FA_BF16_GRAD_REL,
         fa_bf16_dkv_deterministic=True, fa_head_dims=sorted({c[4] for c in cases}),
         rmsnorm_shapes=RN_SHAPES + RN_CASES, rmsnorm_offset_cases=RN_OFFSET_CASES,
         rmsnorm_bodies=bodies, dscale_deterministic=True)

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    results = {}
    fa_rows = [("gemma3-1b", s) for s in GEMMA_FA] + [("granite-8b", dict(GRANITE_FA, layers=0)),
                                                      ("phi-3-vision-4.2b", dict(PHI3V_FA, layers=0))]
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
        library = {"flash_attention_fwd": lib_fwd, "flash_attention_bwd_dq": lib_bwd,
                   "flash_attention_bwd_dkv": lib_bwd,
                   # no single PyTorch call computes delta in f32
                   # (torch.linalg.vecdot of bf16 returns bf16)
                   "flash_attention_bwd_delta": None}
        sink = torch.empty_like(o)
        for name, fn in kern.items():
            nbytes, flops = bounds[name]
            bms, by = bound(nbytes, flops, bf)
            row = dict(model=model, kernel=name, shape=s, max_abs_err=errs[name],
                       grad_rel_err=errs["grad_rel"], kernel_ms=time_ms(fn, flush),
                       plain_ms=plain[name], library_ms=library[name],
                       bound_ms=bms, bound_by=by, bytes=nbytes, flops=flops)
            if name == "flash_attention_bwd_delta":   # a stream of the same bytes
                row["copy_ms"] = time_ms(lambda: sink.copy_(o), flush)
            emit(phase="train_kernels_bf16", fwd_tol=BF16_TOL, grad_rel_tol=FA_BF16_GRAD_REL,
                 **row)
            results.setdefault(name, []).append(row)
        del out, qg, kg, vg
    # K3/K4 at the main paths' shapes (profile_rmsnorm.SHAPES, bf16), held
    # against their plain versions there, beside F.rms_norm
    for model, rows, d, names in prn.SHAPES:
        (x, scale, g), spec = prn.timed(rows, d)
        tag = f"bf16 {model} {(rows, d)}"
        errs = {"rmsnorm_fwd": check(f"K3 {tag}", rn.rmsnorm_fwd_cuda(x, scale),
                                     rnr.rmsnorm_plain(x, scale), RN_BF16_TOL)}
        if "rmsnorm_bwd" in names:
            dx, ds = rn.rmsnorm_bwd_cuda(x, scale, g)
            pdx, pds = rnr.rmsnorm_bwd_plain(x, scale, g)
            errs["rmsnorm_bwd"] = max(check(f"K4 dx {tag}", dx, pdx, RN_BF16_TOL),
                                      check(f"K4 dscale {tag}", ds, pds, RN_DSCALE_TOL))
        for name in names:
            t = spec[name]
            bms, by = bound(t.nbytes, t.flops, bf)
            row = dict(model=model, kernel=name, shape=dict(rows=rows, d=d),
                       max_abs_err=errs[name], kernel_ms=time_ms(t.kernel, flush),
                       plain_ms=time_ms(t.plain, flush), library_ms=time_ms(t.library, flush),
                       bound_ms=bms, bound_by=by, bytes=t.nbytes, flops=t.flops)
            emit(phase="train_kernels_bf16", tol=RN_BF16_TOL, dscale_tol=RN_DSCALE_TOL, **row)
            results.setdefault(name, []).append(row)
    return main_path_rows(results)


def main_path_rows(results):
    """One row per kernel at the training main path's shapes. K1/K2 run at
    two shapes there (4 global layers, 22 with window 512): their row is the
    mean per launch over one step's mix (library_ms None where no library
    call computes it; copy_ms only for delta); K3/K4's is gemma3-1b's shape."""
    rows = {}
    for name, rs in results.items():
        gemma = [r for r in rs if r["model"] == "gemma3-1b"]
        if name.startswith("rmsnorm"):
            rows[name] = gemma[0]
            continue
        n = sum(r["shape"]["layers"] for r in gemma)
        mean = {k: None if gemma[0].get(k) is None else
                sum(r[k] * r["shape"]["layers"] for r in gemma) / n
                for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms", "copy_ms")}
        by = max(gemma, key=lambda r: r["bound_ms"] * r["shape"]["layers"])["bound_by"]
        rows[name] = dict(mean, bound_by=by, max_abs_err=max(r["max_abs_err"] for r in gemma))
    return rows


# ------------------------------------------------------- quant kernels (K8)
def k8_check(tag, x):
    """K8a / K8b on x against the plain versions on the same card tensor,
    bitwise. Returns (codes, scales)."""
    from repro_torch.kernels.blockwise_quant import cuda as bq
    from repro_torch.kernels.blockwise_quant import ref as bqr

    c, s = bq.quantize_cuda(x)
    pc, ps = bqr.quantize_ref(x)
    d = bq.dequantize_cuda(c, s)
    pd = bqr.dequantize_ref(c, s)
    torch.cuda.synchronize()
    for name, a, b in (("codes", c, pc), ("scales", s, ps), ("dequantized", d, pd)):
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(f"K8 {tag}: {name} differ from the plain version in "
                                 f"{bad} of {a.numel()} elements")
    return c, s


# K8a's exhaustive sweep: every f32 in [-1, 1] (the bit patterns 0 ..
# 0x3f800000 and the same with the sign bit), 255 to a block beside a planted
# 1.0, so that x / absmax is x; at most 2^28 values a launch
K8_SWEEP = 2 * (0x3F800000 + 1)
K8_SWEEP_BLOCKS = 2**28 // 256
# K8a's division: block absmaxes from the smallest subnormal to FLT_MAX (the
# reciprocal's range is [2^-64, 2^64]), and the midpoints, their f32
# neighbours, +-0 and +-1 times 2^k in blocks of absmax 2^k
K8_ABSMAX = (2.0**-149, 1e-40, 2.0**-126, 1e-30, 2.0**-65, 2.0**-64, 1.0, 2.0**64, 2.0**65,
             3.0e38, 3.4028235e38)
K8_MID_SHIFTS = (-149, -140, -130, -126, -100, -65, -64, -20, -3, 0, 20, 64, 65, 100, 127)


def planted(values: torch.Tensor, top: float) -> torch.Tensor:
    """``values`` 255 to a 256-value block (the last block padded with 0)
    beside a planted ``top`` at each block's start, flat f32."""
    nb = -(-values.numel() // 255)
    body = F.pad(values.float(), (0, nb * 255 - values.numel())).view(nb, 255)
    return torch.cat([torch.full((nb, 1), top, dtype=torch.float32, device=values.device),
                      body], 1).reshape(-1)


def k8_sweep() -> int:
    """K8a on every f32 in [-1, 1] (``K8_SWEEP``) against the plain version,
    codes and scales bitwise; returns the values swept."""
    from repro_torch.kernels.blockwise_quant import cuda as bq
    from repro_torch.kernels.blockwise_quant import ref as bqr

    per = K8_SWEEP_BLOCKS * 255
    for i0 in range(0, K8_SWEEP, per):
        k = torch.arange(i0, min(i0 + per, K8_SWEEP), dtype=torch.int64, device="cuda")
        half = K8_SWEEP // 2
        bits_ = torch.where(k < half, k, k - half - 2**31)        # sign bit set
        x = planted(bits_.to(torch.int32).view(torch.float32), 1.0)
        c, s = bq.quantize_cuda(x)
        pc, ps = bqr.quantize_ref(x)
        if not (torch.equal(c, pc) and torch.equal(s, ps)):
            bad = (c != pc).nonzero()[:4, 0].tolist()
            raise AssertionError(f"K8a sweep from {i0}: {int((c != pc).sum())} codes differ "
                                 f"from the plain version, e.g. x {x[bad].tolist()} -> "
                                 f"{c[bad].tolist()} vs {pc[bad].tolist()}")
        del k, bits_, x, c, s, pc, ps
    torch.cuda.empty_cache()
    return K8_SWEEP


def k8_division_cases() -> int:
    """K8a / K8b on ``K8_ABSMAX`` and ``K8_MID_SHIFTS`` blocks, and on +-0
    blocks, bitwise; returns the cases."""
    from repro_torch.kernels.blockwise_quant import ref as bqr

    rng = np.random.RandomState(19)
    cases = 0
    for am in K8_ABSMAX:
        top = float(torch.tensor(am, dtype=torch.float32))
        u = torch.tensor(rng.uniform(-1, 1, 255 * 16), dtype=torch.float32, device="cuda")
        k8_check(f"absmax {am}", planted(u * top, top))
        cases += 1
    _, mid = bqr.code_table("cuda")
    vals = torch.cat([mid, torch.nextafter(mid, torch.full_like(mid, 2.0)),
                      torch.nextafter(mid, torch.full_like(mid, -2.0)),
                      torch.tensor([0.0, -0.0, 1.0, -1.0], device="cuda")])
    for k in K8_MID_SHIFTS:
        top = torch.tensor(2.0**k, dtype=torch.float32).item()
        k8_check(f"midpoints x 2^{k}", planted(vals * top, top))
        cases += 1
    for z in (0.0, -0.0):
        k8_check(f"zeros {z}", torch.full((256 * 4,), z, device="cuda"))
        cases += 1
    return cases


def phase_quant_kernels():
    from repro_torch.kernels.blockwise_quant import cuda as bq
    from repro_torch.kernels.blockwise_quant import ops as bqo
    from repro_torch.kernels.blockwise_quant import ref as bqr

    cases = 0
    for n in (256 * 64, 256 * 64 * 4):          # tests/test_kernels_quant_norm.py
        for scale in (1e-4, 1.0, 1e4):
            x = torch.tensor(np.random.RandomState(0).randn(n), dtype=torch.float32)
            k8_check(f"n {n} scale {scale}", (x * scale).to("cuda"))
            cases += 1
    x = torch.zeros(100, device="cuda")           # all-zero, padded to a tile
    c, s, n = bqo.quantize(x)
    k8_check("zeros", F.pad(x, (0, c.numel() - 100)))
    if c.shape != (16384,) or float(bqo.dequantize(c, s, n, (100,)).abs().max()) != 0.0:
        raise AssertionError("K8: a zero input does not come back as zeros")
    cases += 1 + k8_division_cases()
    t0 = time.perf_counter()
    swept = k8_sweep()
    emit(phase="quant_kernels_cases", cases=cases, bitwise=True, sweep_values=swept,
         sweep_s=round(time.perf_counter() - t0, 3))

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(8)
    per_size, v_rows = {}, []
    for n, leaves in pcd.K8_LEAVES:
        # Adam-moment-like values (pcd.k8_input): m, normal with a magnitude
        # that varies by four decades from block to block, then v, squares
        x = pcd.k8_input("m", n, gen)
        c, s = k8_check(f"leaf {n}", x)
        times = {
            "blockwise_quantize": (time_ms(lambda: bq.quantize_cuda(x), flush),
                                   time_ms(lambda: bqr.quantize_ref(x), flush, warmup=2, reps=5)),
            "blockwise_dequantize": (time_ms(lambda: bq.dequantize_cuda(c, s), flush),
                                     time_ms(lambda: bqr.dequantize_ref(c, s), flush,
                                             warmup=2, reps=5)),
        }
        for name, (nbytes, flops) in pcd.k8_bounds(n).items():
            bms, by = bound(nbytes, flops, torch.float32)
            row = dict(kernel=name, n=n, leaves=leaves, kernel_ms=times[name][0],
                       plain_ms=times[name][1], library_ms=None, bound_ms=bms,
                       bound_by=by, bytes=nbytes, flops=flops, max_abs_err=0.0)
            emit(phase="quant_kernels", input="m", library="none: no single PyTorch call "
                 "computes the blockwise dynamic codec", **row)
            per_size.setdefault(name, []).append(row)
        del x, c, s
        x = pcd.k8_input("v", n, gen)
        k8_check(f"leaf {n} v", x)
        v_rows.append(dict(kernel_ms=time_ms(lambda: bq.quantize_cuda(x), flush),
                           bound_ms=per_size["blockwise_quantize"][-1]["bound_ms"],
                           leaves=leaves))
        emit(phase="quant_kernels", input="v", kernel="blockwise_quantize", n=n,
             leaves=leaves, **{k: v_rows[-1][k] for k in ("kernel_ms", "bound_ms")})
        del x
    torch.cuda.empty_cache()
    # one row per kernel: the mean per launch over one step's mix of leaves
    # (m-like input; K8a's v-like mean in a line of its own)
    rows = {}
    total = sum(k for _, k in pcd.K8_LEAVES)
    for name, rs in per_size.items():
        mean = {k: sum(r[k] * r["leaves"] for r in rs) / total
                for k in ("kernel_ms", "plain_ms", "bound_ms")}
        by = max(rs, key=lambda r: r["bound_ms"] * r["leaves"])["bound_by"]
        rows[name] = dict(mean, library_ms=None, bound_by=by, max_abs_err=0.0)
    emit(phase="quant_kernels_mean", kernel="blockwise_quantize", input="v",
         **{k: sum(r[k] * r["leaves"] for r in v_rows) / total for k in ("kernel_ms", "bound_ms")})
    return rows


def phase_train_parity() -> None:
    """Three steps of fit on the card (kernels) against the same three on the
    CPU (plain versions), f32 with TF32 off: reduced gemma3-1b (6 layers,
    window 64 < seq 128) with AdamW; then adam8bit and adam4bit on a 24-layer,
    width-192 variant, whose (24, 192) norm scales are quantized in blocks
    that straddle layers, so K8 runs on every leaf kind of the main path."""
    from repro_torch.configs import get_reduced

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    train_parity_run("adamw", get_reduced("gemma3-1b"))
    for name in ("adam8bit", "adam4bit"):
        train_parity_run(name, get_reduced("gemma3-1b", n_layers=24, d_model=192))


def train_parity_run(name, cfg) -> None:
    from repro_torch.data import DataPipeline
    from repro_torch.launch.train import kernel_launches, reset_kernel_launches
    from repro_torch.models import init_params
    from repro_torch.optim import get as get_opt
    from repro_torch.train import TrainConfig, fit, make_state

    tc = TrainConfig(optimizer=name, precision="f32", lr=1e-4, log_every=1)
    runs = {}
    for dev in ("cpu", "cuda"):
        opt = get_opt(tc.optimizer, tc.lr)
        params = init_params(cfg, seed=7, device="cpu", dtype=torch.float32).to(dev)
        data = DataPipeline(cfg, 2, 128, seed=0)
        reset_kernel_launches()
        try:
            state = make_state(cfg, opt, tc, device=dev, params=params)
            state, hist = fit(cfg, tc, data, 3, opt, state=state, log=lambda line: None)
        finally:
            data.close()
        codes = [q["codes"].cpu() for slot in state["opt"].get("slots", [])
                 for q in slot.values() if isinstance(q, dict)]
        runs[dev] = (hist, [p.detach().float().cpu() for p in state["params"].parameters()],
                     kernel_launches(), codes)
    (h_cpu, p_cpu, cpu_launches, c_cpu), (h_gpu, p_gpu, launches, c_gpu) = runs["cpu"], runs["cuda"]
    need = [k for k in launches
            if not k.startswith("stash") and (not k.startswith("blockwise") or name != "adamw")]
    if min(launches[k] for k in need) <= 0 or max(cpu_launches.values()) != 0:
        raise AssertionError(f"train-parity {name}: a kernel was not launched on the card "
                             f"({launches}), or one was on the CPU ({cpu_launches})")
    worst = {"loss": 0.0, "grad_norm": 0.0, "params": 0.0}
    for a, b in zip(h_gpu, h_cpu):
        for key in ("loss", "grad_norm"):
            if not np.isfinite(a[key]):
                raise AssertionError(f"train-parity {name}: non-finite {key} on the card")
            rel = abs(a[key] - b[key]) / abs(b[key])
            worst[key] = max(worst[key], rel)
    for a, b in zip(p_gpu, p_cpu):
        # per tensor, in norm: Adam moves an element whose gradient sits at
        # the roundoff level by up to lr either way, so single elements of
        # near-zero gradient may differ by more than 1e-3 of their value;
        # a moment code that flips at a bin edge moves one element by a code
        # step
        worst["params"] = max(worst["params"], float((a - b).norm() / b.norm()))
    if max(worst.values()) > 1e-3:
        raise AssertionError(f"train-parity {name}: card vs CPU {worst} > rtol 1e-3")
    differ = sum(int((a != b).sum()) for a, b in zip(c_gpu, c_cpu))
    total = sum(a.numel() for a in c_cpu)
    emit(phase="train_parity", optimizer=name, config=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32, steps=3, rtol=1e-3,
         max_rel_err=worst, losses_cuda=[h["loss"] for h in h_gpu],
         losses_cpu=[h["loss"] for h in h_cpu], launches=launches,
         codes_differing_card_vs_cpu=differ, codes=total,
         codes_differing_share=differ / total if total else None)


def phase_train(wl, name: str):
    """A gemma3-1b training workload of launch/workload.py at full width and
    depth: 10 steps of fit, bf16 over f32 masters, the chunked-CE head, remat
    none; AdamW (phase train) or adam8bit (phase train8). The launch
    counters are read around make_state and fit only."""
    from repro_torch.launch.train import (kernel_launches, optimizer_state_bytes,
                                          reset_kernel_launches)
    from repro_torch.optim import get as get_opt
    from repro_torch.optim import state_bytes
    from repro_torch.train import fit, make_state

    cfg, tc = wl.cfg, wl.tc
    opt = get_opt(tc.optimizer, tc.lr)
    if (wl.batch, wl.seq) != (TRAIN_B, TRAIN_S):
        raise AssertionError(f"train workload {wl.batch} x {wl.seq} != the kernel "
                             f"phase's {TRAIN_B} x {TRAIN_S}")
    reset_kernel_launches()                 # counts of the main path only
    t0 = time.perf_counter()
    state = make_state(cfg, opt, tc, seed=wl.seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in state["params"].parameters())
    opt_bytes, adamw_bytes = optimizer_state_bytes(state)
    data = wl.data()
    torch.cuda.reset_peak_memory_stats()
    try:
        state, hist = fit(cfg, tc, data, TRAIN_STEPS, opt, state=state,
                          log=lambda line: None)
    finally:
        data.close()
    launches = kernel_launches()
    losses = [h["loss"] for h in hist]
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: the loss did not fall: {losses}")
    L = cfg.n_layers
    per_step = {"flash_attention_fwd": L, "flash_attention_bwd_delta": L,
                "flash_attention_bwd_dq": L, "flash_attention_bwd_dkv": L,
                "rmsnorm_fwd": 2 * L + 1, "rmsnorm_bwd": 2 * L + 1}
    # 8-bit Adam: K8b then K8a on m and v of every quantized leaf per step,
    # and K8a on the zero m and v of each at init
    k8 = pcd.K8_PER_STEP if tc.optimizer == "adam8bit" else 0
    want = {k: n * TRAIN_STEPS for k, n in per_step.items()}
    want.update(blockwise_quantize=k8 * (TRAIN_STEPS + 1), blockwise_dequantize=k8 * TRAIN_STEPS,
                stash_quantize=0, stash_dequantize=0)
    if launches != want:
        raise AssertionError(f"{name}: launches {launches} != {want}")
    extra = {}
    if tc.optimizer == "adam8bit":
        slots = int(state_bytes(state["opt"]["slots"]))
        # codes 2 x 999,817,216 padded values, scales 31,244,288 B, the
        # final norm's f32 m and v 9,216 B; AdamW's f32 m and v 7,998,501,888 B
        if (slots, adamw_bytes) != (2_030_887_936, 7_998_501_888):
            raise AssertionError(f"{name}: optimizer state {slots} B, AdamW's "
                                 f"{adamw_bytes} B, not as reckoned from the shapes")
        extra = dict(opt_slots_bytes=slots, k8_per_step=k8, k8a_at_init=k8)
    step_ms = statistics.median(h["step_s"] for h in hist[2:]) * 1e3
    emit(phase=name, config=cfg.name, params=n_params, dtype="bf16 over f32 masters",
         optimizer=tc.optimizer, lr=tc.lr, batch=TRAIN_B, seq=TRAIN_S, remat=tc.remat,
         head="chunked CE", steps=TRAIN_STEPS, params_init_s=init_s,
         median_step_ms=step_ms, tokens_per_s=TRAIN_B * TRAIN_S / (step_ms / 1e3),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         opt_state_bytes=opt_bytes, adamw_state_bytes=adamw_bytes,
         opt_state_ratio=opt_bytes / adamw_bytes,
         first_loss=losses[0], last_loss=losses[-1], losses=losses,
         step_ms=[h["step_s"] * 1e3 for h in hist], launches=launches,
         launches_per_step=per_step, **extra)
    del state
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------- stash kernels (K7)
# tests/test_kernels_quant.py SHAPES; the pipe phase's slot is pcd.STASH_SLOT
STASH_SHAPES = [(3, 7), (257,), (2, 2, 130), (64, 256), (33, 77)]


def bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's raw bytes: -0 against +0, or one fp8 code against its
    neighbour, must not compare equal."""
    return t.contiguous().view(torch.uint8)


def stash_mixed(shape, seed):
    """Normal values whose magnitude moves by eight decades from 256-value
    block to block, on the card."""
    rng = np.random.RandomState(seed)
    n = int(np.prod(shape))
    mag = 10.0 ** rng.uniform(-4, 4, -(-n // 256)).repeat(256)[:n]
    return torch.tensor((rng.randn(n) * mag).reshape(shape), dtype=torch.float32,
                        device="cuda")


def stash_ties():
    """Four blocks of values on rounding ties. Block 0's absmax is 448, so its
    fp8 scale is 1 and x / scale is x: midpoints of neighbouring e4m3 values,
    normal and subnormal, both signs, and -0. Block 1's absmax is 127, its
    int8 scale 1: k + 0.5 for round-half-even. Block 2 is zeros (scale 0),
    block 3 zeros but one -0."""
    fp8 = [448.0, 17.0, 19.0, 1.0625, 432.0, 0.015625 * 1.0625, 2.0**-10, 3 * 2.0**-10,
           5 * 2.0**-10, -17.0, -1.0625, -(2.0**-10), -432.0, -0.0, 0.0]
    int8 = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 63.5, -0.0, 0.0]
    blocks = [np.resize(fp8, 256), np.resize(int8, 256), np.zeros(256), np.zeros(256)]
    blocks[3][7] = -0.0
    return torch.tensor(np.concatenate(blocks), dtype=torch.float32, device="cuda")


def stash_check(tag, x, storage):
    """K7a / K7b (through the ops, as the stash calls them) against the plain
    version on the same card tensor, bitwise. Returns (codes, scales)."""
    from repro_torch.kernels.blockwise_quant import ops as bqo
    from repro_torch.kernels.paged_attention import quant

    c, s = bqo.stash_quantize(x, storage)
    flat = x.reshape(-1)
    n = flat.numel()
    pc, ps = quant.kv_quantize(F.pad(flat, (0, (-n) % 256)).view(-1, 256),
                               quant._QUANT[storage][0])
    d = bqo.stash_dequantize(c, s, tuple(x.shape), x.dtype)
    pd = quant.kv_dequantize(c, s, x.dtype).reshape(-1)[:n].view(x.shape)
    torch.cuda.synchronize()
    for name, a, b in (("codes", c, pc), ("scales", s, ps), ("dequantized", d, pd)):
        if not torch.equal(bits(a), bits(b)):
            bad = int((bits(a) != bits(b)).sum())
            raise AssertionError(f"K7 {tag}: {name} differ from the plain version in "
                                 f"{bad} of {bits(a).numel()} bytes")
    return c, s


def ptxas_of(source: str, key: str) -> dict:
    """Registers and spills of the entry functions of ``source`` whose
    mangled names hold ``key``, from nvcc's -Xptxas -v log."""
    from repro_torch.kernels import build

    out, name = {}, None
    for ln in build.library_path(source).with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif name and key in name and "registers" in ln and "Used " in ln:
            out.setdefault(name, {})["registers"] = int(ln.split("Used ")[1].split()[0])
        elif name and key in name and "spill" in ln:
            out.setdefault(name, {})["spills"] = ln.strip()
    return out


# K7a's bf16 sweep: block absmaxes 2^k, 1.5 * 2^k (k = -133 .. 127 by 4: bf16
# subnormals to 2^127) and the largest finite bf16
STASH_ABSMAX = ([2.0**k for k in range(-133, 128, 4)] + [1.5 * 2.0**k for k in range(-131, 127, 8)]
                + [3.3895313892515355e38])


def stash_bf16_sweep(storage) -> int:
    """K7a / K7b on every finite bf16 value under each ``STASH_ABSMAX``: the
    values of magnitude at most the absmax, 255 to a block beside it,
    bitwise; returns the absmaxes run."""
    every = torch.arange(-2**15, 2**15, dtype=torch.int32, device="cuda").to(torch.int16)
    every = every.view(torch.bfloat16).float()
    every = every[torch.isfinite(every)]
    for am in STASH_ABSMAX:
        top = torch.tensor(am).to(torch.bfloat16).float()
        x = planted(every[every.abs() <= top], top.item()).to(torch.bfloat16)
        stash_check(f"{storage} bf16 sweep absmax {top.item():.6g}", x, storage)
    return len(STASH_ABSMAX)


def phase_stash_kernels():
    from repro_torch.kernels.blockwise_quant import cuda as bq
    from repro_torch.kernels.blockwise_quant import ops as bqo
    from repro_torch.kernels.paged_attention import quant

    cases = 0
    for storage in ("int8", "fp8"):
        for dt in (torch.float32, torch.bfloat16):
            for i, shape in enumerate(STASH_SHAPES + [(100,), pcd.STASH_SLOT]):
                stash_check(f"{storage} {dt} {shape}", stash_mixed(shape, i).to(dt), storage)
                cases += 1
            stash_check(f"{storage} {dt} ties", stash_ties().to(dt), storage)
            c, s = stash_check(f"{storage} {dt} 100 zeros", torch.zeros(100, dtype=dt,
                                                                        device="cuda"), storage)
            if c.shape != (1, 256) or float(s[0]) != 0.0:
                raise AssertionError("K7: a zero input does not pad to one block of scale 0")
            cases += 2
    for storage in ("int8", "fp8"):
        cases += stash_bf16_sweep(storage)
    # the main path's call: K7a writes into a slot's rows, K7b reads them
    x = pcd.stash_input()
    codes = torch.zeros((3,) + (x.numel() // 256, 256), dtype=torch.int8, device="cuda")
    scales = torch.zeros((3, x.numel() // 256), device="cuda")
    bqo.stash_quantize(x, "int8", out=(codes[1], scales[1]))
    pc, ps = quant.kv_quantize(x.view(-1, 256), torch.int8)
    torch.cuda.synchronize()
    if not (torch.equal(codes[1], pc) and torch.equal(bits(scales[1]), bits(ps))
            and not codes[0].any() and not codes[2].any()):
        raise AssertionError("K7a into a slot's rows differs from the plain version")
    emit(phase="stash_kernels_cases", cases=cases + 1, bitwise=True,
         ptxas=ptxas_of(bq.SOURCE, "stash"))

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    rows = {}
    n = x.numel()
    for storage in ("int8", "fp8"):
        sdt = quant._QUANT[storage][0]
        c, s = bqo.stash_quantize(x, storage)
        times = {
            "stash_quantize": (
                time_ms(lambda: bqo.stash_quantize(x, storage, out=(c, s)), flush),
                time_ms(lambda: quant.kv_quantize(x.view(-1, 256), sdt), flush, warmup=2, reps=10)),
            "stash_dequantize": (
                time_ms(lambda: bqo.stash_dequantize(c, s, pcd.STASH_SLOT, torch.bfloat16), flush),
                time_ms(lambda: quant.kv_dequantize(c, s, torch.bfloat16), flush, warmup=2,
                        reps=10)),
        }
        for name, (nbytes, flops) in pcd.stash_bounds(n, 2, 2).items():
            bms, by = bound(nbytes, flops, torch.float32)
            row = dict(kernel=name, storage=storage, shape=pcd.STASH_SLOT, dtype="bf16",
                       kernel_ms=times[name][0], plain_ms=times[name][1], library_ms=None,
                       bound_ms=bms, bound_by=by, bytes=nbytes, flops=flops, max_abs_err=0.0)
            emit(phase="stash_kernels", library="none: no single PyTorch call computes "
                 "the blockwise symmetric codec", **row)
            if storage == "int8":          # the pipe phase's stash
                rows[name] = row
    return rows


def phase_pipe_parity() -> None:
    """Three pipeline steps (build_train_pipeline_host, 1F1B, P = 2, M = 4)
    on the card against the same three on the CPU, f32 with TF32 off, on
    reduced granite-8b with 4 layers, with the raw and the int8 stash."""
    from repro_torch.configs import get_reduced

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_reduced("granite-8b", n_layers=4)
    for stash in ("raw", "int8"):
        pipe_parity_run(cfg, stash)


def pipe_parity_run(cfg, stash) -> None:
    from repro_torch.core.partitioner import ParallelPlan
    from repro_torch.core.stash import get_backend
    from repro_torch.data import DataPipeline
    from repro_torch.kernels.blockwise_quant import ops as bqo
    from repro_torch.launch.train import (build_train_pipeline_host, kernel_launches,
                                          reset_kernel_launches)
    from repro_torch.models import Runtime, init_params, pipeline_fns, pipeline_shared
    from repro_torch.optim import get as get_opt
    from repro_torch.train import TrainConfig, fit, make_state, plan_fields

    plan = ParallelPlan(pp=2, microbatches=4, stash=stash)
    tc = TrainConfig(precision="f32", lr=1e-4, log_every=1, **plan_fields(plan))
    first_fn, stage_fn, _ = pipeline_fns(cfg, Runtime(dtype=torch.float32))
    runs = {}
    for dev in ("cpu", "cuda"):
        opt = get_opt(tc.optimizer, tc.lr)
        params = init_params(cfg, seed=7, device="cpu", dtype=torch.float32).to(dev)
        step_fn, _ = build_train_pipeline_host(cfg, plan, tc)
        data = DataPipeline(cfg, 8, 128, seed=0)
        reset_kernel_launches()
        try:
            state = make_state(cfg, opt, tc, device=dev, params=params)
            state, hist = fit(cfg, tc, data, 3, opt, state=state, step_fn=step_fn,
                              log=lambda line: None)
            launches = kernel_launches()
            batch = next(data)
        finally:
            data.close()
        # the int8 codes of stage 1's input (microbatch 0 of a fourth batch)
        # from the trained params, as the stash would store them
        lm = state["params"]
        with torch.no_grad():
            mb = {k: torch.as_tensor(v[:2]).to(dev) for k, v in batch.items()}
            x0 = get_backend(stash).roundtrip(first_fn(pipeline_shared(lm), mb))
            y, _ = stage_fn(list(lm.stack.layers)[:2], x0)
            codes, _ = bqo.stash_quantize(y, "int8")
        runs[dev] = (hist, [p.detach().float().cpu() for p in lm.parameters()], launches,
                     codes.view(torch.uint8).cpu())
    (h_cpu, p_cpu, cpu_launches, c_cpu), (h_gpu, p_gpu, launches, c_gpu) = runs["cpu"], runs["cuda"]
    need = [k for k in launches if not k.startswith("blockwise")
            and (stash == "int8" or not k.startswith("stash"))]
    if (min(launches[k] for k in need) <= 0 or max(cpu_launches.values()) != 0
            or launches["blockwise_quantize"] or launches["blockwise_dequantize"]):
        raise AssertionError(f"pipe-parity {stash}: launches on the card {launches}, "
                             f"on the CPU {cpu_launches}")
    if stash == "raw" and (launches["stash_quantize"] or launches["stash_dequantize"]):
        raise AssertionError(f"pipe-parity raw: K7 launched {launches}")
    worst = {"loss": 0.0, "grad_norm": 0.0, "params": 0.0}
    for a, b in zip(h_gpu, h_cpu):
        for key in ("loss", "grad_norm"):
            if not np.isfinite(a[key]):
                raise AssertionError(f"pipe-parity {stash}: non-finite {key} on the card")
            worst[key] = max(worst[key], abs(a[key] - b[key]) / abs(b[key]))
    for a, b in zip(p_gpu, p_cpu):
        # per tensor, in norm, as train-parity: Adam's step moves elements of
        # roundoff-level gradient by up to lr either way
        worst["params"] = max(worst["params"], float((a - b).norm() / b.norm()))
    if max(worst.values()) > 1e-3:
        raise AssertionError(f"pipe-parity {stash}: card vs CPU {worst} > rtol 1e-3")
    differ = int((c_gpu != c_cpu).sum())
    emit(phase="pipe_parity", stash=stash, config=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, plan=plan.describe(),
         allow_tf32=torch.backends.cuda.matmul.allow_tf32, steps=3, rtol=1e-3,
         max_rel_err=worst, losses_cuda=[h["loss"] for h in h_gpu],
         losses_cpu=[h["loss"] for h in h_cpu], launches=launches,
         stage1_int8_codes_differing=differ, codes=c_cpu.numel(),
         codes_differing_share=differ / c_cpu.numel())


def pipe_launches_per_step(cfg, plan) -> dict:
    """Launches per step of the pipe workload that its tick tables fix (L
    layers, P stages, M microbatches, stash int8, cotangents raw): every
    layer runs forward in its F op and again in its B op's recompute, and
    backward once; the final norm runs only in the last stage's B op; K7a
    quantizes every put (each forward arrival, and stage 0's own) and stage
    0's roundtrip, K7b dequantizes each F get, each B get and the
    roundtrip."""
    L, P, M = cfg.n_layers, plan.pp, plan.microbatches
    return {"flash_attention_fwd": 2 * L * M, "flash_attention_bwd_delta": L * M,
            "flash_attention_bwd_dq": L * M, "flash_attention_bwd_dkv": L * M,
            "rmsnorm_fwd": 4 * L * M + M, "rmsnorm_bwd": 2 * L * M + M,
            "blockwise_quantize": 0, "blockwise_dequantize": 0,
            "stash_quantize": P * M + M, "stash_dequantize": 2 * P * M + M}


PIPE_WARMUP, PIPE_STEPS = 2, 3


def grads_peaks(fn, peaks: list):
    """``fn`` (pipeline_grads_host) recording, per call, the bytes allocated
    before it and the peak across it alone (the optimizer step after it is
    not in the window)."""
    def wrapped(*args, **kw):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        peaks.append((base, torch.cuda.max_memory_allocated()))
        return out
    return wrapped


def b_op_bytes(wl, plan, state, batch) -> int:
    """The most bytes any stage's backward op takes above what was allocated
    before it, each op alone on one microbatch: the stage's forward recorded
    for autograd, its loss on the last stage, and ``autograd.grad`` into its
    and the shared params' f32 grads, as the runner's B op does."""
    from repro_torch.core.pipeline import parameters_of
    from repro_torch.models import Runtime, pipeline_fns, pipeline_shared

    first_fn, stage_fn, last_fn = pipeline_fns(wl.cfg, Runtime(dtype=torch.bfloat16,
                                                                remat=plan.remat))
    lm = state["params"]
    shared, layers = pipeline_shared(lm), list(lm.stack.layers)
    k, P = len(layers) // plan.pp, plan.pp
    mb = {key: torch.as_tensor(v[:wl.batch // plan.microbatches]).to("cuda")
          for key, v in batch.items()}
    worst = 0
    for s in range(P):
        with torch.no_grad():
            x0 = first_fn(shared, mb).to(torch.bfloat16)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.enable_grad():
            x = first_fn(shared, mb).to(torch.bfloat16) if s == 0 else x0.requires_grad_(True)
            y, aux = stage_fn(layers[s * k:(s + 1) * k], x)
            loss = aux.float()
            if s == P - 1:
                loss = loss + last_fn(shared, y, mb)[0]
            outs, cots = ([y], [torch.ones_like(y)]) if s < P - 1 else ([], [])
            if loss.requires_grad:
                outs.append(loss)
                cots.append(torch.ones((), device="cuda"))
            leaves = parameters_of(layers[s * k:(s + 1) * k]) + parameters_of(shared)
            grads = torch.autograd.grad(outs, leaves + ([x] if s else []), cots,
                                        allow_unused=True)
        torch.cuda.synchronize()
        worst = max(worst, torch.cuda.max_memory_allocated() - base)
        del x0, x, y, aux, loss, outs, cots, grads
    return worst


def pipe_run(wl, stash, steps_before, steps, host_window=2, lookahead=2, probe=None):
    """``steps_before`` then ``steps`` steps of the pipe workload with
    ``stash``, from its seed; the launch counters are reset between the two.
    Returns the history of the second run, its launches, its peak GB over
    whole steps and, across pipeline_grads_host alone, the bytes allocated
    before the call and its peak (the most over the steps), the stash backend,
    the seconds to make the state, the count of parameters and what
    ``probe(state, batch)`` returns after the steps."""
    import dataclasses

    import repro_torch.core.pipeline as pipeline
    from repro_torch.launch.train import (build_train_pipeline_host, kernel_launches,
                                          reset_kernel_launches)
    from repro_torch.optim import get as get_opt
    from repro_torch.train import fit, make_state

    plan = dataclasses.replace(wl.plan, stash=stash)
    tc = dataclasses.replace(wl.tc, stash=stash)
    opt = get_opt(tc.optimizer, tc.lr)
    t0 = time.perf_counter()
    state = make_state(wl.cfg, opt, tc, seed=wl.seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in state["params"].parameters())
    peaks, plain_runner = [], pipeline.pipeline_grads_host
    pipeline.pipeline_grads_host = grads_peaks(plain_runner, peaks)   # bound at build
    try:
        step_fn, backend = build_train_pipeline_host(wl.cfg, plan, tc,
                                                     host_window=host_window,
                                                     lookahead=lookahead)
    finally:
        pipeline.pipeline_grads_host = plain_runner
    data = wl.data()
    try:
        if steps_before:
            state, _ = fit(wl.cfg, tc, data, steps_before, opt, state=state,
                           step_fn=step_fn, log=lambda line: None)
        reset_kernel_launches()
        peaks.clear()
        state, hist = fit(wl.cfg, tc, data, steps, opt, state=state, step_fn=step_fn,
                          log=lambda line: None)
        launches = kernel_launches()
        grads_base = max(b for b, _ in peaks)
        grads_peak = max(p for _, p in peaks)
        peak = max(grads_peak, torch.cuda.max_memory_allocated()) / 1e9
        probed = probe(state, next(data)) if probe else None
    finally:
        data.close()
    del state
    torch.cuda.empty_cache()
    return dict(hist=hist, launches=launches, peak=peak, grads_base=grads_base,
                grads_peak=grads_peak, backend=backend, init_s=init_s, params=n_params,
                probed=probed)


def phase_pipe(wl):
    """granite_pipe_workload: 2 warm-up and 3 timed steps with the int8
    stash; the counters read around the timed steps only. Returns the
    launches and the run."""
    from repro_torch.core.stash import SlotSpec, get_backend

    cfg, plan = wl.cfg, wl.plan
    run = pipe_run(wl, plan.stash, PIPE_WARMUP, PIPE_STEPS)
    hist, launches = run["hist"], run["launches"]
    losses = [h["loss"] for h in hist]
    if len(losses) != PIPE_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"pipe: losses {losses}")
    per_step = pipe_launches_per_step(cfg, plan)
    want = {k: v * PIPE_STEPS for k, v in per_step.items()}
    if launches != want:
        raise AssertionError(f"pipe: launches {launches} != {want}")
    rep = plan.stash_report(cfg, global_batch=wl.batch, seq_len=wl.seq, itemsize=2)
    spec = SlotSpec((wl.batch // plan.microbatches, wl.seq, cfg.d_model), torch.bfloat16,
                    torch.device("cuda"))
    slot = get_backend(plan.stash).slot_bytes(spec)
    # one slot holds n bf16 values: int8 codes n B + a 4 B scale per 256 (at
    # 1 x 2048 x 4096: 8,519,680 B), raw 2n B (16,777,216 B)
    n = spec.numel
    if (rep["bytes_per_slot"], rep["raw_bytes_per_slot"], slot) != (n + n // 64, 2 * n,
                                                                    n + n // 64):
        raise AssertionError(f"pipe: stash report {rep}, slot bytes {slot}")
    step_ms = statistics.median(h["step_s"] for h in hist) * 1e3
    emit(phase="pipe", config=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
         params=run["params"], dtype="bf16 over f32 masters", optimizer=wl.tc.optimizer,
         lr=wl.tc.lr, batch=wl.batch, seq=wl.seq, plan=plan.describe(), head="dense",
         warmup_steps=PIPE_WARMUP, steps=PIPE_STEPS, params_init_s=run["init_s"],
         median_step_ms=step_ms, tokens_per_s=wl.tokens_per_step / (step_ms / 1e3),
         peak_mem_gb=run["peak"], grads_peak_gb=run["grads_peak"] / 1e9,
         grads_base_gb=run["grads_base"] / 1e9, losses=losses,
         step_ms=[h["step_s"] * 1e3 for h in hist],
         launches=launches, launches_per_step=per_step, stash_report=rep)
    return launches, run


def phase_pipe_host(wl, int8) -> None:
    """The pipe workload with the raw and with the host stash (window 2,
    lookahead 2), 2 steps each from the same seed: the same bits. Then the
    runner's memory point, across pipeline_grads_host alone, as the rise of
    its peak over what was allocated before the call: the int8 run (``int8``,
    phase_pipe's) and the host run rise no more than the raw run, whose rise
    is at
    most its f32 grad accumulators, its raw slots, the in-flight wires and
    cotangent slots, and one backward op's working set measured alone (F ops
    that recorded graphs would keep a stage's activations per microbatch in
    flight on top)."""
    from repro_torch.core.pipeline import tick_table

    plan = wl.plan
    raw = pipe_run(wl, "raw", 0, 2,
                   probe=lambda state, batch: b_op_bytes(wl, plan, state, batch))
    host = pipe_run(wl, "host", 0, 2)
    h_raw, h_host, backend = raw["hist"], host["hist"], host["backend"]
    for key in ("loss", "grad_norm"):
        a, b = [h[key] for h in h_raw], [h[key] for h in h_host]
        if a != b:
            raise AssertionError(f"pipe-host: {key} with the host stash {b} != raw {a}")
    stats = backend.stats()
    if not (stats["evictions"] and stats["host_hits"]):
        raise AssertionError(f"pipe-host: the host stash never left the device: {stats}")
    table = tick_table(plan.schedule, plan.pp, plan.microbatches)
    slot = 2 * (wl.batch // plan.microbatches) * wl.seq * wl.cfg.d_model   # raw bf16
    accum = 4 * raw["params"]
    slots = plan.pp * table.n_act_slots * slot
    wires = (2 * plan.pp + plan.pp * table.n_cot_slots) * slot
    b_op = raw["probed"]
    rise = {name: r["grads_peak"] - r["grads_base"]
            for name, r in (("raw", raw), ("int8", int8), ("host", host))}
    limit = accum + slots + wires + b_op
    if not (rise["int8"] <= rise["raw"] and rise["host"] <= rise["raw"] <= limit):
        raise AssertionError(
            f"pipe-host: peak rises across pipeline_grads_host {rise} B; the raw one's "
            f"limit: accumulators {accum} + slots {slots} + wires {wires} + one B op "
            f"{b_op} = {limit}")
    host_hits = max(stats["host_hits"], 1)
    emit(phase="pipe_host", losses=[h["loss"] for h in h_raw], bitwise_equal=True,
         window=2, lookahead=2, stats=stats,
         stall_fraction=stats["stalled_gets"] / host_hits,
         prefetch_hit_rate=stats["prefetch_hits"] / host_hits,
         step_ms_raw=[h["step_s"] * 1e3 for h in h_raw],
         step_ms_host=[h["step_s"] * 1e3 for h in h_host],
         peak_mem_gb_raw=raw["peak"], peak_mem_gb_host=host["peak"],
         grads_peak_gb={k: r["grads_peak"] / 1e9 for k, r in
                        (("raw", raw), ("int8", int8), ("host", host))},
         grads_rise_bytes=rise, rise_limit_bytes=limit,
         rise_limit_parts={"accumulators": accum, "raw_slots": slots, "wires": wires,
                           "one_b_op": b_op})


def phase_model() -> None:
    """Reduced granite-8b, f32: the port on the card (kernels) against the
    port on the CPU (plain versions) — prefill chunks, then decode steps —
    with the pool at f32 and as int8 and fp8 codes, each at rtol 1e-3. A
    quantized pool's codes are written from K/V rows that the card's and the
    CPU's matmuls round differently, so a few codes may sit one step apart:
    the share of codes that differ card vs CPU is printed beside the error."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import (Runtime, decode_step_paged, init_paged_state,
                                    init_params, prefill_chunk_paged)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_reduced("granite-8b", n_kv_heads=2)
    cpu = init_params(cfg, seed=3, device="cpu", dtype=torch.float32)
    gpu = init_params(cfg, seed=3, device="cpu", dtype=torch.float32).to("cuda")
    rng = np.random.RandomState(5)
    prompt = rng.randint(0, cfg.vocab_size, 45).astype(np.int32)
    for kv_dtype in ("", "int8", "fp8"):
        rt = Runtime(dtype=torch.float32, kv_dtype=kv_dtype)
        worst = 0.0
        outs, pools = {}, {}
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
            pools[dev] = {k: v.cpu() for k, v in st["caches"].items()}
        for a, b in zip(outs["cpu"], outs["cuda"]):
            if not torch.isfinite(b).all():
                raise AssertionError(f"non-finite logits on the card ({kv_dtype or 'f32'})")
            torch.testing.assert_close(b, a, atol=1e-3, rtol=1e-3)
            worst = max(worst, float((a - b).abs().max() / a.abs().max()))
        row = dict(phase="model", config=cfg.name, pool=kv_dtype or "f32", max_rel_err=worst,
                   tol=1e-3)
        if kv_dtype:
            differ = sum(int((pools["cpu"][k].view(torch.uint8)
                              != pools["cuda"][k].view(torch.uint8)).sum()) for k in "kv")
            total = sum(pools["cpu"][k].numel() for k in "kv")
            row.update(codes_differ_share=differ / total, scales_max_rel_diff=max(
                float(((pools["cpu"][k] - pools["cuda"][k]).abs()
                       / pools["cpu"][k].abs().clamp(min=1e-30)).max()) for k in ("ksc", "vsc")))
        emit(**row)


def phase_serve(kv_dtype: str = "bf16", params=None):
    """launch/workload.py's granite-8b serving workload with the pool at
    ``kv_dtype``: the requests' tokens, exact launch counts of the pool's
    K5/K6 variant (the other variants at 0) and K3, tokens/s, TTFT, pool
    bytes and peak memory. ``params`` from an earlier serve phase are reused
    (the same seed)."""
    from repro_torch.kernels.paged_attention import cuda
    from repro_torch.kernels.rmsnorm import cuda as rn
    from repro_torch.launch.workload import granite_serve_workload
    from repro_torch.serve import ServeEngine

    wl = granite_serve_workload(kv_dtype=kv_dtype)
    cfg, rt, ecfg, prompts, new = wl.cfg, wl.rt, wl.ecfg, wl.prompts, wl.new_tokens
    t0 = time.perf_counter()
    if params is None:
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
    pool_dtype = eng._dev["caches"]["k"].dtype
    k5, k6 = cuda.variant(cuda.DECODE, pool_dtype), cuda.variant(cuda.PREFILL, pool_dtype)
    if launches[k5] <= 0 or launches[k6] <= 0:
        raise AssertionError(f"a kernel was not launched on the main path: {launches}")
    others = {k: v for k, v in launches.items() if k not in (k5, k6) and v}
    if others:
        raise AssertionError(f"{kv_dtype} pool launched other variants: {others}")
    chunks = s["prefill_chunks"] - chunks0
    if launches[k6] != L * chunks:
        raise AssertionError(f"K6 launches {launches} != {L} x {chunks}")
    if launches[k5] % L:
        raise AssertionError(f"K5 launches {launches} not a multiple of {L}")
    passes = chunks + launches[k5] // L
    if k3 != passes * (2 * L + 1):         # two norms per layer and the final one
        raise AssertionError(f"K3 launches {k3} != {passes} passes x {2 * L + 1}")
    emit(phase="serve" if kv_dtype == "bf16" else f"serve-{kv_dtype}", config=cfg.name,
         dtype="bf16", kv_dtype=kv_dtype, pool_dtype=str(pool_dtype), params_init_s=init_s,
         requests=len(rids), new_tokens=new, num_pages=ecfg.num_pages,
         tokens_per_s=s["tokens_per_s"], run_mean_ttft_s=s["run_mean_ttft_s"],
         wall_s=s["wall_s"], prefill_chunks=chunks, decode_steps=launches[k5] // L,
         launches=launches, rmsnorm_fwd_launches=k3,
         kv_pool_bytes=s["kv_pool_bytes_per_device"],
         kv_bytes_per_token=eng._kv_bytes_per_page() // ecfg.page_size,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del eng
    torch.cuda.empty_cache()
    return wl, params, rids, out, {k5: launches[k5], k6: launches[k6]}


def phase_alone(wl, params, rids, out) -> None:
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(wl.cfg, params, wl.rt, wl.ecfg, device="cuda")
    for i in (0, 5):
        rid = eng.submit(wl.prompts[i], wl.new_tokens)
        alone = eng.run()[rid]
        if not np.array_equal(alone, out[rids[i]]):
            raise AssertionError(f"request {i} ({wl.ecfg.kv_dtype} pool): batched "
                                 f"{out[rids[i]][:8]} != alone {alone[:8]}")
    emit(phase="alone", kv_dtype=wl.ecfg.kv_dtype, requests=[0, 5], identical=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.launch.workload import (gemma_train8_workload, gemma_train_workload,
                                             granite_pipe_workload)

    phase_card()
    phase_build()
    kern = phase_kernels()
    kern.update(phase_kernels_quant())
    phase_kernels_long()
    kern.update(phase_train_kernels())
    kern.update(phase_quant_kernels())
    kern.update(phase_stash_kernels())
    phase_model()
    phase_train_parity()
    phase_pipe_parity()
    launches = phase_train(gemma_train_workload(), "train")     # K1-K4
    train8 = phase_train(gemma_train8_workload(), "train8")     # K1-K4 and K8
    launches.update({k: v for k, v in train8.items() if k.startswith("blockwise")})
    pipe = granite_pipe_workload()
    pipe_launches, pipe_int8 = phase_pipe(pipe)                 # K1-K4 and K7
    launches.update({k: v for k, v in pipe_launches.items() if k.startswith("stash")})
    phase_pipe_host(pipe, pipe_int8)
    wl, params, rids, out, serve_launches = phase_serve()
    phase_alone(wl, params, rids, out)
    launches.update(serve_launches)        # K5, K6: the serving main path
    for kv_dtype in QUANT_STORAGE:         # and over int8 / fp8 pools
        wl, params, rids, out, serve_launches = phase_serve(kv_dtype, params)
        phase_alone(wl, params, rids, out)
        launches.update(serve_launches)
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
