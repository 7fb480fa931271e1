"""The port's plain paged-attention versions against the JAX package's
oracles and its Pallas kernels (interpret mode), in f32 at 2e-5 — the cases
of tests/test_paged_attention.py, over pools at q's dtype and over int8 /
fp8 pools with their scales (the same codes and scales, from the port's
kv_quantize, handed to both packages). Also: the port's ops take the plain
path for CPU tensors, and the kernel modules import without triton, nvcc or
a card. The CUDA kernels themselves are held against the plain versions on
the card (chip_smoke.py, and the ``cuda``-marked test below)."""
import subprocess
import sys

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import (
    paged_attention_ref,
    paged_prefill_attention_ref,
)
from repro.kernels.paged_attention.kernel import (
    paged_attention_kernel,
    paged_prefill_attention_kernel,
)
from repro_torch.kernels.paged_attention import cuda, ops, quant, ref

TOL = dict(atol=2e-5, rtol=2e-5)


def make_case(B, Kv, G, hd, page, N, P, lengths, seed=0):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, Kv, G, hd) * hd ** -0.5).astype(np.float32)
    kp = rng.randn(N, page, Kv, hd).astype(np.float32)
    vp = rng.randn(N, page, Kv, hd).astype(np.float32)
    tables = np.zeros((B, P), np.int32)
    nxt = 1
    for b, L in enumerate(lengths):
        n = -(-L // page)
        tables[b, :n] = np.arange(nxt, nxt + n)
        nxt += n
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


def make_prefill_case(B, T, Kv, G, hd, page, N, P, starts, qlens, seed=0):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, T, Kv, G, hd) * hd ** -0.5).astype(np.float32)
    kp = rng.randn(N, page, Kv, hd).astype(np.float32)
    vp = rng.randn(N, page, Kv, hd).astype(np.float32)
    tables = np.zeros((B, P), np.int32)
    nxt = 1
    for b in range(B):
        n = -(-(starts[b] + T) // page)
        tables[b, :n] = np.arange(nxt, nxt + n)
        nxt += n
    return (q, kp, vp, tables, np.asarray(starts, np.int32),
            np.asarray(qlens, np.int32))


def jx(arrays):
    return [jnp.asarray(a) for a in arrays]


def th(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


CASES = [
    (1, 1, 1, 32, 8, 8, 4, [13]),          # MQA
    (3, 2, 4, 32, 8, 32, 4, [13, 27, 5]),  # GQA
    (2, 4, 2, 64, 16, 16, 4, [64, 33]),    # exact + off multiple
    (2, 2, 8, 32, 4, 32, 8, [1, 31]),      # single-token request
]
PREFILL_CASES = [
    (1, 8, 1, 4, 32, 4, 24, 12, [0], [8]),       # MQA, cold chunk
    (2, 4, 2, 2, 32, 8, 16, 4, [0, 5], [4, 3]),  # GQA, offset + ragged
    (1, 8, 1, 4, 32, 4, 24, 12, [13], [6]),      # mid-prompt chunk
    (3, 4, 2, 4, 16, 8, 32, 4, [0, 9, 17], [4, 2, 1]),  # mixed depths
]
# groups of more than 8 query rows a kv head, which the CUDA kernels take in
# chunks of 8 (decode, f32 prefill) or in 64-row tiles over (t, g) (bf16
# prefill): recurrentgemma-2b's G 10 and granite-34b's G 48, at small hd
LARGE_G_CASES = [
    (2, 1, 10, 32, 8, 16, 4, [13, 30]),
    (2, 1, 48, 16, 8, 16, 4, [9, 27]),
]
LARGE_G_PREFILL_CASES = [
    (2, 4, 1, 10, 32, 8, 16, 4, [3, 11], [4, 3]),
    (2, 4, 1, 48, 16, 8, 16, 4, [0, 13], [4, 2]),
]
# chunks of more than one row tile of the CUDA kernels (32 rows in the first
# design, 64 in the tensor-core one) at nonzero starts; G=3 puts a tile edge inside
# one position's rows
MULTI_TILE_CASES = [
    (2, 16, 2, 4, 32, 4, 16, 8, [5, 13], [16, 11]),
    (1, 12, 1, 3, 64, 8, 8, 4, [9], [12]),
    (1, 16, 2, 4, 128, 16, 8, 6, [40], [16]),
    (1, 24, 1, 3, 64, 8, 16, 6, [9], [24]),
    (2, 32, 2, 4, 128, 16, 16, 8, [5, 40], [32, 25]),
]


@pytest.mark.parametrize("case", CASES + LARGE_G_CASES,
                         ids=[str(c[:4]) for c in CASES + LARGE_G_CASES])
@pytest.mark.parametrize("window", [0, 6])
def test_decode_plain_matches_jax_ref_and_kernel(case, window):
    arrays = make_case(*case)
    out = ref.paged_attention_plain(*th(arrays), window=window).numpy()
    jref = np.asarray(paged_attention_ref(*jx(arrays), window=window))
    jker = np.asarray(paged_attention_kernel(*jx(arrays), window=window,
                                             interpret=True))
    np.testing.assert_allclose(out, jref, **TOL)
    np.testing.assert_allclose(out, jker, **TOL)


@pytest.mark.parametrize(
    "case", PREFILL_CASES + MULTI_TILE_CASES + LARGE_G_PREFILL_CASES,
    ids=[str(c[:4]) for c in PREFILL_CASES + MULTI_TILE_CASES + LARGE_G_PREFILL_CASES])
@pytest.mark.parametrize("window", [0, 6])
def test_prefill_plain_matches_jax_ref_and_kernel(case, window):
    arrays = make_prefill_case(*case)
    qlens = case[-1]
    out = ref.paged_prefill_attention_plain(*th(arrays), window=window).numpy()
    jref = np.asarray(paged_prefill_attention_ref(*jx(arrays), window=window))
    jker = np.asarray(paged_prefill_attention_kernel(*jx(arrays), window=window,
                                                     interpret=True))
    for b, L in enumerate(qlens):      # rows t >= q_len are garbage by contract
        np.testing.assert_allclose(out[b, :L], jref[b, :L], **TOL)
        np.testing.assert_allclose(out[b, :L], jker[b, :L], **TOL)


# ---------------------------------------------------- quantized pools
# the JAX suite's quantized cases (tests/test_paged_attention.py: CASES[:2]
# decode, one GQA prefill chunk), and a G 10 case of each
QUANT_DECODE = CASES[:2] + LARGE_G_CASES[:1]
QUANT_PREFILL = [(2, 4, 2, 2, 32, 8, 16, 4, [0, 5], [4, 3])] + LARGE_G_PREFILL_CASES[:1]
KV_DTYPES = ["int8", "fp8"]


def quantize_pools(arrays, kv_dtype):
    """f32 (q, kp, vp, tables, *ints) -> the port's arguments and the JAX
    package's, the pools as codes of ``kv_dtype`` and f32 scales from the
    port's kv_quantize: the same bytes on both sides."""
    q, kp, vp, tables, *ints = arrays
    store = quant.kv_storage_dtype(kv_dtype, torch.float32)
    kc, ks = quant.kv_quantize(torch.from_numpy(kp), store)
    vc, vs = quant.kv_quantize(torch.from_numpy(vp), store)

    def to_jax(codes):
        if codes.dtype == torch.int8:
            return jnp.asarray(codes.numpy())
        return jnp.asarray(codes.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn))

    t_args = th([q]) + [kc, vc] + th([tables, *ints])
    j_args = jx([q]) + [to_jax(kc), to_jax(vc)] + jx([tables, *ints])
    t_sc = dict(k_scale=ks, v_scale=vs)
    j_sc = dict(k_scale=jnp.asarray(ks.numpy()), v_scale=jnp.asarray(vs.numpy()))
    return t_args, t_sc, j_args, j_sc


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("case", QUANT_DECODE, ids=[str(c[:4]) for c in QUANT_DECODE])
@pytest.mark.parametrize("window", [0, 6])
def test_quantized_decode_plain_matches_jax_ref(case, window, kv_dtype):
    t_args, t_sc, j_args, j_sc = quantize_pools(make_case(*case), kv_dtype)
    out = ref.paged_attention_plain(*t_args, window=window, **t_sc).numpy()
    jref = np.asarray(paged_attention_ref(*j_args, window=window, **j_sc))
    np.testing.assert_allclose(out, jref, **TOL)


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("case", QUANT_PREFILL, ids=[str(c[:4]) for c in QUANT_PREFILL])
@pytest.mark.parametrize("window", [0, 6])
def test_quantized_prefill_plain_matches_jax_ref(case, window, kv_dtype):
    t_args, t_sc, j_args, j_sc = quantize_pools(make_prefill_case(*case), kv_dtype)
    out = ref.paged_prefill_attention_plain(*t_args, window=window, **t_sc).numpy()
    jref = np.asarray(paged_prefill_attention_ref(*j_args, window=window, **j_sc))
    for b, L in enumerate(case[-1]):
        np.testing.assert_allclose(out[b, :L], jref[b, :L], **TOL)


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_quantized_plain_matches_pallas_interpret(kind, kv_dtype):
    """The Pallas kernels' fused in-gather dequantization, in interpret mode,
    on one small case each (window 6)."""
    if kind == "decode":
        t_args, t_sc, j_args, j_sc = quantize_pools(make_case(*CASES[1]), kv_dtype)
        out = ref.paged_attention_plain(*t_args, window=6, **t_sc).numpy()
        jker = np.asarray(paged_attention_kernel(*j_args, window=6, interpret=True, **j_sc))
        np.testing.assert_allclose(out, jker, **TOL)
        return
    case = QUANT_PREFILL[0]
    t_args, t_sc, j_args, j_sc = quantize_pools(make_prefill_case(*case), kv_dtype)
    out = ref.paged_prefill_attention_plain(*t_args, window=6, **t_sc).numpy()
    jker = np.asarray(paged_prefill_attention_kernel(*j_args, window=6, interpret=True,
                                                     **j_sc))
    for b, L in enumerate(case[-1]):
        np.testing.assert_allclose(out[b, :L], jker[b, :L], **TOL)


def test_quantized_null_page_dequantizes_to_zero():
    """Zero scales make the null page read as exact zeros whatever codes it
    holds: poisoned codes change nothing, and every output is finite."""
    t_args, t_sc, _, _ = quantize_pools(make_case(2, 2, 2, 16, 8, 16, 4, [9, 12], seed=1),
                                        "int8")
    t_sc["k_scale"][0] = 0.0
    t_sc["v_scale"][0] = 0.0
    clean = ref.paged_attention_plain(*t_args, **t_sc)
    t_args[1][0], t_args[2][0] = 127, -127
    out = ref.paged_attention_plain(*t_args, **t_sc)
    assert torch.isfinite(out).all()
    np.testing.assert_array_equal(out.numpy(), clean.numpy())
    assert (quant.kv_dequantize(t_args[1][0], t_sc["k_scale"][0]) == 0).all()


def test_plain_versions_take_scales_in_pairs():
    """A quantized pool needs both scales: one alone is refused."""
    t_args, t_sc, _, _ = quantize_pools(make_case(*CASES[1]), "int8")
    with pytest.raises(ValueError, match="both"):
        ref.paged_attention_plain(*t_args, k_scale=t_sc["k_scale"])
    t_args, t_sc, _, _ = quantize_pools(make_prefill_case(*QUANT_PREFILL[0]), "int8")
    with pytest.raises(ValueError, match="both"):
        ref.paged_prefill_attention_plain(*t_args, v_scale=t_sc["v_scale"])


def test_ops_pass_the_scales_on_cpu(monkeypatch):
    """The CPU ops hand a quantized pool's scales to the plain versions; the
    CUDA wrappers and their counters are never touched."""
    def refuse(*a, **k):
        raise AssertionError("CUDA path taken for a CPU tensor")

    monkeypatch.setattr(cuda, "paged_decode_attention_cuda", refuse)
    monkeypatch.setattr(cuda, "paged_prefill_attention_cuda", refuse)
    before = dict(cuda.LAUNCHES)
    t_args, t_sc, _, _ = quantize_pools(make_case(*CASES[1]), "fp8")
    got = ops.paged_attention(*t_args, window=6, **t_sc)
    assert torch.equal(got, ref.paged_attention_plain(*t_args, window=6, **t_sc))
    assert not torch.equal(got, ref.paged_attention_plain(
        *t_args, window=6, k_scale=t_sc["k_scale"] * 2, v_scale=t_sc["v_scale"]))
    t_args, t_sc, _, _ = quantize_pools(make_prefill_case(*QUANT_PREFILL[0]), "int8")
    assert torch.equal(ops.paged_prefill_attention(*t_args, **t_sc),
                       ref.paged_prefill_attention_plain(*t_args, **t_sc))
    assert cuda.LAUNCHES == before


def test_quantized_cuda_wrappers_refuse_cpu_tensors_and_count_by_variant():
    """A quantized pool's wrappers launch or raise too; their launches count
    under the variant's own key."""
    t_args, t_sc, _, _ = quantize_pools(make_case(*CASES[0]), "int8")
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda.paged_decode_attention_cuda(*t_args, **t_sc)
    t_args, t_sc, _, _ = quantize_pools(make_prefill_case(*PREFILL_CASES[0]), "fp8")
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda.paged_prefill_attention_cuda(*t_args, **t_sc)
    assert cuda.variant(cuda.DECODE, torch.int8) == "paged_decode_attention_int8"
    assert cuda.variant(cuda.PREFILL, torch.float8_e4m3fn) == "paged_prefill_attention_fp8"
    assert cuda.variant(cuda.DECODE, torch.bfloat16) == cuda.DECODE
    assert set(cuda.LAUNCHES) == {f"{op}{v}" for op in (cuda.DECODE, cuda.PREFILL)
                                  for v in ("", "_int8", "_fp8")}


def test_poisoned_null_page_is_masked():
    """1e3 / -1e3 in the null page must not reach any valid row."""
    q, kp, vp, tables, lens = make_case(2, 2, 2, 16, 8, 16, 4, [9, 12], seed=1)
    clean = ref.paged_attention_plain(*th((q, kp, vp, tables, lens)))
    kp[0], vp[0] = 1e3, -1e3
    out = ref.paged_attention_plain(*th((q, kp, vp, tables, lens)))
    jker = paged_attention_kernel(*jx((q, kp, vp, tables, lens)), interpret=True)
    np.testing.assert_allclose(out.numpy(), clean.numpy(), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jker), **TOL)

    arrays = list(make_prefill_case(2, 4, 2, 2, 32, 8, 16, 4, [3, 11], [4, 2], seed=3))
    clean = ref.paged_prefill_attention_plain(*th(arrays))
    arrays[1][0], arrays[2][0] = 1e3, -1e3
    out = ref.paged_prefill_attention_plain(*th(arrays))
    for b, L in enumerate([4, 2]):
        np.testing.assert_allclose(out[b, :L].numpy(), clean[b, :L].numpy(), **TOL)


def test_prefill_t1_equals_decode():
    q, kp, vp, tbl, st, ln = make_prefill_case(
        2, 1, 2, 2, 16, 8, 16, 4, [6, 11], [1, 1], seed=7
    )
    pre = ref.paged_prefill_attention_plain(*th((q, kp, vp, tbl, st, ln)))
    dec = ref.paged_attention_plain(*th((q[:, 0], kp, vp, tbl, st + 1)))
    np.testing.assert_allclose(pre[:, 0].numpy(), dec.numpy(), atol=1e-6, rtol=1e-6)


def test_prefill_causality_ignores_future_garbage():
    q, kp, vp, tbl, st, ln = make_prefill_case(
        1, 4, 2, 2, 16, 8, 16, 4, [2], [4], seed=5
    )
    clean = ref.paged_prefill_attention_plain(*th((q, kp, vp, tbl, st, ln)))
    last = 2 + 4 - 1
    page = kp.shape[1]
    for j in range(tbl.shape[1]):
        pid = int(tbl[0, j])
        for s in range(page):
            if j * page + s > last and pid != 0:
                kp[pid, s], vp[pid, s] = 1e3, -1e3
    out = ref.paged_prefill_attention_plain(*th((q, kp, vp, tbl, st, ln)))
    jref = paged_prefill_attention_ref(*jx((q, kp, vp, tbl, st, ln)))
    np.testing.assert_allclose(out.numpy(), clean.numpy(), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jref), **TOL)


def test_ops_take_the_plain_path_for_cpu_tensors(monkeypatch):
    """CPU tensors run the plain version; the CUDA wrappers, their library
    and their launch counters are never touched."""
    def refuse(*a, **k):
        raise AssertionError("CUDA path taken for a CPU tensor")

    monkeypatch.setattr(cuda, "paged_decode_attention_cuda", refuse)
    monkeypatch.setattr(cuda, "paged_prefill_attention_cuda", refuse)
    monkeypatch.setattr(cuda, "library", refuse)
    before = dict(cuda.LAUNCHES)
    arrays = th(make_case(*CASES[1]))
    np.testing.assert_array_equal(
        ops.paged_attention(*arrays, window=6).numpy(),
        ref.paged_attention_plain(*arrays, window=6).numpy(),
    )
    arrays = th(make_prefill_case(*PREFILL_CASES[1]))
    np.testing.assert_array_equal(
        ops.paged_prefill_attention(*arrays).numpy(),
        ref.paged_prefill_attention_plain(*arrays).numpy(),
    )
    assert cuda.LAUNCHES == before


def test_cuda_wrappers_refuse_cpu_tensors():
    """The wrappers launch the kernel or raise; they never compute on CPU."""
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda.paged_decode_attention_cuda(*th(make_case(*CASES[0])))
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda.paged_prefill_attention_cuda(*th(make_prefill_case(*PREFILL_CASES[0])))


def test_kernel_modules_import_without_triton_nvcc_or_cuda():
    code = (
        "import sys\n"
        "import repro_torch.kernels.paged_attention as pa\n"
        "import repro_torch.kernels.paged_attention.cuda as c\n"
        "import repro_torch.kernels.build as b\n"
        "assert 'triton' not in sys.modules\n"
        "assert not b._LOADED\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


# shapes of the split plan: (lengths, window, page, P). Serving's, the
# split edges, and a 32,768-key table (P 2,048 of page 16) whose grid is
# capped, with and without a window; "cap edges": rows at and just past the
# cap, and a window of 32 splits' keys that starts off a split boundary and
# so meets 33 of them
PLAN_SHAPES = [
    ([561, 590, 600, 633], 0, 16, 40),          # granite-8b decode
    ([1030, 1100, 1250, 1400], 512, 16, 90),    # gemma3-1b decode
    ([64, 63, 65, 1, 128, 129], 6, 16, 16),     # split edges
    ([1, 1024, 2047, 2048, 2049, 32768], 0, 16, 2048),
    ([1, 1024, 2047, 2048, 2049, 32768], 4096, 16, 2048),
    ([2048, 2049, 2112, 3000, 4097, 20000], 2048, 16, 2048),
]
PLAN_IDS = ["granite", "gemma3", "edges", "long", "long-w4096", "cap-edges"]
# (split, max_splits): K5 and f32 K6's plan, and bf16 K6's over a row
# tile's keys
PLAN_KINDS = {"decode": (cuda.DECODE_SPLIT, cuda.DECODE_MAX_SPLITS),
              "prefill": (cuda.PREFILL_SPLIT, cuda.PREFILL_MAX_SPLITS)}


@pytest.mark.parametrize("kind", list(PLAN_KINDS))
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=PLAN_IDS)
def test_decode_split_plan_fits_the_grid_and_covers_each_slot(shape, kind):
    """The grid's split count comes from the table's width, capped, and each
    slot's ranges, from its own keys alone, lie inside it and cover exactly
    its keys — for the serving shapes, a 32,768-key table and the inactive
    slots the engine leaves (length 1 on a zeroed row, 0, and past the
    table's P * page keys). A slot whose keys meet at most max_splits
    ranges keeps the fixed-split plan: ``split``-key ranges from lo's, each
    in its own column when the grid is not capped."""
    lengths, window, page, P = shape
    split, cap = PLAN_KINDS[kind]
    S = cuda.n_splits(split, page, P, cap)
    assert S == min(-(-P * page // split), cap)
    inactive = [0, 1, P * page, P * page + 1, P * page + 500]
    for L in lengths + inactive:
        lo, hi = cuda.decode_keys(L, window, page, P)
        plan = cuda.splits_of(lo, hi, split, cap, S)
        assert 0 <= plan.col0 and plan.col0 + plan.count <= S, (L, plan, S)
        if hi <= lo:
            assert plan.count == 0
            continue
        assert plan.length % split == 0 and plan.first == lo // split * split
        assert plan.first <= lo < plan.first + plan.length           # the first holds lo
        end = plan.first + plan.count * plan.length
        assert end - plan.length < hi <= end, (L, plan)              # the last holds hi - 1
        assert hi <= P * page and (window == 0 or hi - lo <= window)
        fixed = (split, lo // split * split, -(-hi // split) - lo // split)
        if fixed[2] <= cap:
            assert plan[:3] == fixed, (L, plan, fixed)
            if S == -(-P * page // split):
                assert plan.col0 == lo // split
        else:
            assert plan.count <= cap and plan.length > split


@pytest.mark.parametrize("P, decode_S, prefill_S", [(40, 10, 5), (2048, 32, 16)],
                         ids=["serve-tables", "32768-keys"])
def test_workspace_holds_every_split_partial(P, decode_S, prefill_S):
    """acc (rows, S, hd) and (m, l) (rows, S, 2) in f32, from shapes alone:
    granite-8b's decode (B 4, Kv 8, G 4) and its bf16 and f32 q_len-128
    chunk (4,096 rows), at the serve workload's tables (P 40 of page 16) and
    at a 32,768-key table, where the capped grid bounds them: 2.1 MB for the
    decode and 34 MB for the bf16 chunk, against 34 MB and 545 MB uncapped."""
    S = cuda.n_splits(cuda.DECODE_SPLIT, 16, P, cuda.DECODE_MAX_SPLITS)
    assert S == decode_S
    assert cuda.workspace_floats(4 * 8 * 4, S, 128) == 128 * decode_S * 130
    Sp = cuda.n_splits(cuda.PREFILL_SPLIT, 16, P, cuda.PREFILL_MAX_SPLITS)
    assert Sp == prefill_S
    assert cuda.workspace_floats(128 * 8 * 4, Sp, 128) == 4096 * prefill_S * 130
    if P == 40:       # unchanged by the cap
        assert 4 * cuda.workspace_floats(4096, Sp, 128) == 10_649_600
    else:
        assert 4 * cuda.workspace_floats(128, S, 128) == 2_129_920 <= 4 * 2**20
        assert 4 * cuda.workspace_floats(4096, Sp, 128) == 34_078_720 <= 64 * 2**20
        assert 4 * cuda.workspace_floats(4096, 256, 128) == 545_259_520   # uncapped
        assert 4 * cuda.workspace_floats(4096, S, 128) == 68_157_440      # f32 chunk


@pytest.mark.parametrize("kernel, family", [
    ("paged_decode_split_kernel<__nv_bfloat16, 128, 4>", "K5"),
    ("paged_decode_combine_kernel<__nv_bfloat16, 128>", "K5"),
    ("paged_prefill_mma_kernel<128>", "K6"),
    ("paged_prefill_rows_kernel<float, 128, 4>", "K6"),
    ("paged_prefill_combine_kernel<float, 64>", "K6"),
    ("paged_decode_split_kernel<__nv_bfloat16, signed char, 128, 4>",
     "K5 paged_decode_kernel int8"),
    ("paged_prefill_mma_kernel<128, __nv_fp8_e4m3>", "K6 paged_prefill_kernel fp8"),
])
def test_profile_serve_counts_every_kernel_to_its_op(kernel, family):
    """profile_serve.py sums the device time of each CUDA kernel of an op,
    the split kernels and the combines, into that op's family."""
    from repro_torch.launch.profile_serve import _family

    assert _family(f"void (anonymous namespace)::{kernel}(int)").startswith(family)


def _card_cases(dtype):
    """(kind, arrays, qlens) of every case of chip_smoke.py's kernels phase
    that the JAX suite has, on the card, in ``dtype``."""
    for case in CASES:
        arrays = [t.cuda() for t in th(make_case(*case))]
        yield "decode", [a.to(dtype) if a.is_floating_point() else a for a in arrays], None
    for case in PREFILL_CASES + MULTI_TILE_CASES:
        arrays = [t.cuda() for t in th(make_prefill_case(*case))]
        yield ("prefill", [a.to(dtype) if a.is_floating_point() else a for a in arrays],
               case[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain_on_the_card(dtype):
    """On an H100: both kernels against their plain versions (f32 2e-5, bf16
    4e-3: one rounding to bf16 on both sides), windows 0 and 6, multi-tile
    prefill chunks included; and batched == alone, bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with python3 chip_smoke.py")
    dt = getattr(torch, dtype)
    tol = TOL if dt == torch.float32 else dict(atol=4e-3, rtol=4e-3)
    for window in (0, 6):
        for kind, arrays, qlens in _card_cases(dt):
            if kind == "decode":
                out = cuda.paged_decode_attention_cuda(*arrays, window=window)
                plain = ref.paged_attention_plain(*arrays, window=window)
                torch.testing.assert_close(out.float(), plain.float(), **tol)
            else:
                out = cuda.paged_prefill_attention_cuda(*arrays, window=window)
                plain = ref.paged_prefill_attention_plain(*arrays, window=window)
                for b, L in enumerate(qlens):
                    torch.testing.assert_close(out[b, :L].float(), plain[b, :L].float(),
                                               **tol)
            q, kp, vp, tables, *ints = arrays
            for b in range(q.shape[0]):       # batched == alone, bitwise
                alone_args = (q[b:b + 1].contiguous(), kp, vp, tables[b:b + 1].contiguous(),
                              *[t[b:b + 1].contiguous() for t in ints])
                if kind == "decode":
                    alone = cuda.paged_decode_attention_cuda(*alone_args, window=window)
                    assert torch.equal(out[b:b + 1], alone)
                else:
                    alone = cuda.paged_prefill_attention_cuda(*alone_args, window=window)
                    assert torch.equal(out[b:b + 1, :qlens[b]], alone[:, :qlens[b]])


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_cuda_kernels_match_plain_on_the_card(dtype, kv_dtype):
    """On an H100: both kernels over int8 / fp8 pools against their plain
    versions on the same codes and scales (f32 q 2e-5, bf16 q 4e-3), windows
    0 and 6, the JAX suite's quantized cases and their G 10 cases."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with python3 chip_smoke.py")
    dt = getattr(torch, dtype)
    tol = TOL if dt == torch.float32 else dict(atol=4e-3, rtol=4e-3)

    def card(t_args, t_sc):
        args = [t.cuda() for t in t_args]
        args[0] = args[0].to(dt)
        return args, {k: v.cuda() for k, v in t_sc.items()}

    for window in (0, 6):
        for case in QUANT_DECODE:
            args, sc = card(*quantize_pools(make_case(*case), kv_dtype)[:2])
            torch.testing.assert_close(
                cuda.paged_decode_attention_cuda(*args, window=window, **sc).float(),
                ref.paged_attention_plain(*args, window=window, **sc).float(), **tol)
        for case in QUANT_PREFILL:
            args, sc = card(*quantize_pools(make_prefill_case(*case), kv_dtype)[:2])
            out = cuda.paged_prefill_attention_cuda(*args, window=window, **sc)
            plain = ref.paged_prefill_attention_plain(*args, window=window, **sc)
            for b, L in enumerate(case[-1]):
                torch.testing.assert_close(out[b, :L].float(), plain[b, :L].float(), **tol)
