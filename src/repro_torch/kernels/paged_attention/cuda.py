"""ctypes wrappers of the CUDA kernels in ``csrc/paged_attention.cu``.

Each wrapper checks device, dtype, shape, contiguity and alignment, allocates
its output and the kernels' f32 workspace of split partials with
``torch.empty``, launches on the current CUDA stream (a split kernel, then
the combine that merges the splits in order), raises when the C launcher
returns a nonzero ``cudaGetLastError()``, and adds one to its entry of
``LAUNCHES`` per call — only there, so a run can show that it went through
the kernels. A quantized pool (int8 or ``float8_e4m3fn`` codes, with f32
``k_scale`` / ``v_scale`` of shape (N, page, Kv)) runs the same kernels
templated on the code type, and counts under its own key
(``paged_decode_attention_int8``, ``..._fp8``), so a run shows which variant
ran; q and the output stay f32 or bf16.

The split plan: K5 (and f32 K6, per query position) splits a slot's keys
into ranges of ``DECODE_SPLIT`` keys; bf16 K6 splits each row tile of
``PREFILL_TILE_ROWS`` rows into ranges of ``PREFILL_SPLIT`` keys. The grid and
the workspace hold ``S = min(ceil(P * page / split), max_splits)`` columns
(``DECODE_MAX_SPLITS``, ``PREFILL_MAX_SPLITS``), so that the workspace is
bounded whatever the table's width; a row whose keys meet more than
``max_splits`` ranges takes longer ones, a multiple of ``split`` keys. Which
ranges a row uses depends on its own slot's length (or start and q_len)
alone, and the kernel finds them itself (``splits_of`` mirrors it here).
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build

SOURCE = "paged_attention/csrc/paged_attention.cu"
DECODE = "paged_decode_attention"
PREFILL = "paged_prefill_attention"
# pool code types beside the native one (the pool at q's dtype): the C
# interface's kv code, and the suffix of the variant's LAUNCHES key
_CODES = {torch.int8: (1, "int8"), torch.float8_e4m3fn: (2, "fp8")}
LAUNCHES: Dict[str, int] = {
    f"{op}{suffix}": 0 for op in (DECODE, PREFILL)
    for suffix in ("", "_int8", "_fp8")
}

# the kernel's constants (paged_attention_constant checks them at load)
DECODE_SPLIT = 64        # keys per K5 split, and per f32 K6 split
PREFILL_SPLIT = 128      # keys per bf16 K6 split
PREFILL_TILE_ROWS = 64   # flattened (t, g) rows per bf16 K6 block
DECODE_MAX_SPLITS = 32   # split columns of a K5 / f32 K6 grid, at most
PREFILL_MAX_SPLITS = 16  # split columns of a bf16 K6 grid, at most
HEAD_DIMS = (16, 32, 64, 96, 128, 256)   # head sizes the source builds
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        lib.paged_decode_attention.argtypes = [_P] * 9 + [_I] * 10 + [_P]
        lib.paged_decode_attention.restype = _I
        lib.paged_prefill_attention.argtypes = [_P] * 10 + [_I] * 11 + [_P]
        lib.paged_prefill_attention.restype = _I
        lib.paged_attention_constant.argtypes = [_I]
        lib.paged_attention_constant.restype = _I
        got = tuple(lib.paged_attention_constant(i) for i in range(5))
        if got != (DECODE_SPLIT, PREFILL_SPLIT, PREFILL_TILE_ROWS, DECODE_MAX_SPLITS,
                   PREFILL_MAX_SPLITS):
            raise RuntimeError(f"{SOURCE} splits {got} != the wrapper's plan")
        lib._typed = True
    return lib


def n_splits(split: int, page: int, P: int, max_splits: int) -> int:
    """Split columns of the grid and the workspace: the table's width, capped
    at ``max_splits``."""
    return max(1, min(math.ceil(P * page / split), max_splits))


class SplitPlan(NamedTuple):
    """A row's ranges: ``count`` of ``length`` keys from key ``first``, range
    i in grid column ``col0 + i``."""
    length: int
    first: int
    count: int
    col0: int


def splits_of(lo: int, hi: int, split: int, max_splits: int, S: int) -> SplitPlan:
    """The ranges that cover keys [lo, hi) in a grid of ``S`` columns; the
    kernel's ``plan_of``. A row whose keys meet at most ``max_splits``
    ``split``-key ranges (from lo rounded down to ``split``) takes them; a
    longer row takes ranges of ``split * ceil(n / max_splits)`` keys for its
    n, so that it needs at most ``max_splits`` columns."""
    if lo >= hi:
        return SplitPlan(split, 0, 0, 0)
    first = lo // split
    n = -(-hi // split) - first
    k = -(-n // max_splits)
    count = -(-n // k)
    return SplitPlan(split * k, first * split, count, min(first, S - count))


def decode_keys(length: int, window: int, page: int, P: int) -> Tuple[int, int]:
    """Keys [lo, hi) a decode row of a slot of ``length`` tokens reads: its
    window, capped at the table's P * page keys; the kernel's ``keys_of``."""
    qpos = length - 1
    lo = max(0, qpos - window + 1) if window > 0 else 0
    return lo, min(qpos + 1, P * page)


def workspace_floats(rows: int, S: int, hd: int) -> int:
    """f32 partials: acc (rows, S, hd) then (m, l) (rows, S, 2)."""
    return rows * S * (hd + 2)


def variant(name: str, pool_dtype: torch.dtype) -> str:
    """The ``LAUNCHES`` key of op ``name`` over a pool of ``pool_dtype``."""
    return name + (f"_{_CODES[pool_dtype][1]}" if pool_dtype in _CODES else "")


def _scale_ptrs(q, k_pages, k_scale, v_scale) -> Tuple[int, int, int]:
    """(kv code, k_scale pointer, v_scale pointer): 0 and null pointers for a
    pool at q's dtype; a quantized pool needs both scales, f32, contiguous,
    (N, page, Kv) on q's device."""
    if k_pages.dtype not in _CODES:
        if k_scale is not None or v_scale is not None:
            raise ValueError(f"scales given for a {k_pages.dtype} pool")
        return 0, 0, 0
    if k_scale is None or v_scale is None:
        raise ValueError(f"a {k_pages.dtype} pool needs k_scale and v_scale")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.dtype != torch.float32 or t.device != q.device:
            raise TypeError(f"{name} must be float32 on {q.device}")
        if t.shape != k_pages.shape[:3]:
            raise ValueError(f"{name} shape {tuple(t.shape)} != pool's "
                             f"{tuple(k_pages.shape[:3])}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return _CODES[k_pages.dtype][0], k_scale.data_ptr(), v_scale.data_ptr()


def _check(q, k_pages, v_pages, tables, ints, G, hd, page):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype} not in {list(_DTYPES)}")
    if k_pages.dtype != q.dtype and k_pages.dtype not in _CODES:
        raise TypeError(f"pool dtype {k_pages.dtype} is neither q's {q.dtype} "
                        f"nor a code type {list(_CODES)}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != k_pages.dtype or t.device != dev:
            raise TypeError(f"{name} must be {k_pages.dtype} on {dev}")
        if t.shape != k_pages.shape or t.shape[-1] != hd:
            raise ValueError(f"{name} shape {tuple(t.shape)} does not fit q")
    for name, t in (("tables", tables),) + ints:
        if t.dtype != torch.int32 or t.device != dev:
            raise TypeError(f"{name} must be int32 on {dev}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("tables", tables)) + ints:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS} (the sizes built)")
    if G < 1:
        raise ValueError(f"group size {G} < 1")
    if not 4 <= page <= 64:
        raise ValueError(f"page size {page} not in 4..64")


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def paged_decode_attention_cuda(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    window: int = 0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K5 on the card. q (B, Kv, G, hd) pre-scaled; pools (N, page, Kv, hd)
    at q's dtype, or int8 / fp8 codes with scales (N, page, Kv) f32; tables
    (B, P) int32; lengths (B,) int32 -> (B, Kv, G, hd) q.dtype."""
    B, Kv, G, hd = q.shape
    page = k_pages.shape[1]
    P = tables.shape[1]
    if k_pages.shape[2] != Kv or tables.shape[0] != B or lengths.shape != (B,):
        raise ValueError("shapes of q, pools, tables and lengths disagree")
    _check(q, k_pages, v_pages, tables, (("lengths", lengths),), G, hd, page)
    code, ks, vs = _scale_ptrs(q, k_pages, k_scale, v_scale)
    S = n_splits(DECODE_SPLIT, page, P, DECODE_MAX_SPLITS)
    out = torch.empty_like(q)
    ws = torch.empty(workspace_floats(B * Kv * G, S, hd), dtype=torch.float32,
                     device=q.device)
    with torch.cuda.device(q.device):
        err = library().paged_decode_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), ks, vs,
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), ws.data_ptr(),
            B, Kv, G, hd, page, P, int(window), S, _DTYPES[q.dtype], code,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    name = variant(DECODE, k_pages.dtype)
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out


def paged_prefill_attention_cuda(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    tables: torch.Tensor,
    start: torch.Tensor,
    q_len: torch.Tensor,
    *,
    window: int = 0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K6 on the card. q (B, T, Kv, G, hd) pre-scaled; pools and scales as
    for K5; start, q_len (B,) int32 -> (B, T, Kv, G, hd) q.dtype (rows t >=
    q_len are garbage). bf16 q runs on the tensor cores, f32 q on the CUDA
    cores (TF32 would fail f32's 2e-5): the choice is by q's dtype alone."""
    B, T, Kv, G, hd = q.shape
    page = k_pages.shape[1]
    P = tables.shape[1]
    if (k_pages.shape[2] != Kv or tables.shape[0] != B
            or start.shape != (B,) or q_len.shape != (B,)):
        raise ValueError("shapes of q, pools, tables, start and q_len disagree")
    _check(q, k_pages, v_pages, tables, (("start", start), ("q_len", q_len)),
           G, hd, page)
    code, ks, vs = _scale_ptrs(q, k_pages, k_scale, v_scale)
    if q.dtype == torch.bfloat16:
        S = n_splits(PREFILL_SPLIT, page, P, PREFILL_MAX_SPLITS)
    else:
        S = n_splits(DECODE_SPLIT, page, P, DECODE_MAX_SPLITS)
    out = torch.empty_like(q)
    ws = torch.empty(workspace_floats(B * T * Kv * G, S, hd), dtype=torch.float32,
                     device=q.device)
    with torch.cuda.device(q.device):
        err = library().paged_prefill_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), ks, vs,
            tables.data_ptr(), start.data_ptr(), q_len.data_ptr(),
            out.data_ptr(), ws.data_ptr(), B, T, Kv, G, hd, page, P, int(window), S,
            _DTYPES[q.dtype], code, torch.cuda.current_stream(q.device).cuda_stream,
        )
    name = variant(PREFILL, k_pages.dtype)
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out
