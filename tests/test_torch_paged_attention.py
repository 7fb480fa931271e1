"""The port's plain paged-attention versions against the JAX package's
oracles and its Pallas kernels (interpret mode), in f32 at 2e-5 — the cases
of tests/test_paged_attention.py. Also: the port's ops take the plain path
for CPU tensors, and the kernel modules import without triton, nvcc or a
card. The CUDA kernels themselves are held against the plain versions on
the card (chip_smoke.py, and the ``cuda``-marked test below)."""
import subprocess
import sys

import jax.numpy as jnp
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
from repro_torch.kernels.paged_attention import cuda, ops, ref

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


# serving shapes of the split plan: (lengths, window, page, P)
PLAN_SHAPES = [
    ([561, 590, 600, 633], 0, 16, 40),          # granite-8b decode
    ([1030, 1100, 1250, 1400], 512, 16, 90),    # gemma3-1b decode
    ([64, 63, 65, 1, 128, 129], 6, 16, 16),     # split edges
]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=["granite", "gemma3", "edges"])
def test_decode_split_plan_fits_the_grid_and_covers_each_slot(shape):
    """The grid's split count comes from the table's width alone, and each
    slot's splits, from its own length alone, lie inside it and cover
    exactly its keys — for the serving shapes and for the inactive slots the
    engine leaves (length 1 on a zeroed row, 0, and past the table's P *
    page keys)."""
    lengths, window, page, P = shape
    split = cuda.DECODE_SPLIT
    S = cuda.n_splits(split, page, P)
    assert S == -(-P * page // split)
    inactive = [0, 1, P * page, P * page + 1, P * page + 500]
    for L in lengths + inactive:
        lo, hi = cuda.decode_keys(L, window, page, P)
        first, count = cuda.splits_of(lo, hi, split)
        assert 0 <= first and first + count <= S, (L, first, count, S)
        if hi > lo:
            assert first * split <= lo < (first + 1) * split
            assert (first + count - 1) * split < hi <= (first + count) * split
            assert hi <= P * page and (window == 0 or hi - lo <= window)
        else:
            assert count == 0


def test_workspace_holds_every_split_partial():
    """acc (rows, S, hd) and (m, l) (rows, S, 2) in f32, from shapes alone:
    granite-8b's decode (B 4, Kv 8, G 4) and its bf16 and f32 q_len-128 chunk."""
    S = cuda.n_splits(cuda.DECODE_SPLIT, 16, 40)
    assert S == 10
    assert cuda.workspace_floats(4 * 8 * 4, S, 128) == 128 * 10 * 130
    assert cuda.n_splits(cuda.PREFILL_SPLIT, 16, 40) == 5
    assert cuda.workspace_floats(128 * 8 * 4, 5, 128) == 4096 * 5 * 130


@pytest.mark.parametrize("kernel, family", [
    ("paged_decode_split_kernel<__nv_bfloat16, 128, 4>", "K5"),
    ("paged_decode_combine_kernel<__nv_bfloat16, 128>", "K5"),
    ("paged_prefill_mma_kernel<128>", "K6"),
    ("paged_prefill_rows_kernel<float, 128, 4>", "K6"),
    ("paged_prefill_combine_kernel<float, 64>", "K6"),
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
