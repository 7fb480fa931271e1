"""ctypes wrappers of the two CUDA kernels in ``csrc/paged_attention.cu``.

Each wrapper checks device, dtype, shape, contiguity and alignment, allocates
its output with ``torch.empty``, launches on the current CUDA stream, raises
when the C launcher returns a nonzero ``cudaGetLastError()``, and adds one to
its entry of ``LAUNCHES`` — only there, so a run can show that it went
through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import build

SOURCE = "paged_attention/csrc/paged_attention.cu"
DECODE = "paged_decode_attention"
PREFILL = "paged_prefill_attention"
LAUNCHES: Dict[str, int] = {DECODE: 0, PREFILL: 0}

# Flattened (t, g) query rows one prefill block holds.
PREFILL_ROWS = 32
MAX_SMEM_BYTES = 232_448          # dynamic shared memory one H100 block may use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        lib.paged_decode_attention.argtypes = [_P] * 6 + [_I] * 8 + [_P]
        lib.paged_decode_attention.restype = _I
        lib.paged_prefill_attention.argtypes = [_P] * 7 + [_I] * 10 + [_P]
        lib.paged_prefill_attention.restype = _I
        lib.paged_attention_smem_bytes.argtypes = [_I] * 3
        lib.paged_attention_smem_bytes.restype = ctypes.c_size_t
        lib._typed = True
    return lib


def _check(q, k_pages, v_pages, tables, ints, G, hd, page, rows):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype} not in {list(_DTYPES)}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != q.dtype or t.device != dev:
            raise TypeError(f"{name} must be {q.dtype} on {dev}")
        if t.shape != k_pages.shape or t.shape[-1] != hd:
            raise ValueError(f"{name} shape {tuple(t.shape)} does not fit q")
    for name, t in (("tables", tables),) + ints:
        if t.dtype != torch.int32 or t.device != dev:
            raise TypeError(f"{name} must be int32 on {dev}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("tables", tables)) + ints:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if not 16 <= hd <= 256 or hd % 8:
        raise ValueError(f"head_dim {hd} not in 16..256 or not a multiple of 8")
    if not 1 <= G <= 8:
        raise ValueError(f"group size {G} not in 1..8")
    if not 4 <= page <= 64:
        raise ValueError(f"page size {page} not in 4..64")
    smem = library().paged_attention_smem_bytes(rows, hd, page)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{smem} bytes of shared memory > {MAX_SMEM_BYTES}")


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
) -> torch.Tensor:
    """K5 on the card. q (B, Kv, G, hd) pre-scaled; pools (N, page, Kv, hd);
    tables (B, P) int32; lengths (B,) int32 -> (B, Kv, G, hd) q.dtype."""
    B, Kv, G, hd = q.shape
    page = k_pages.shape[1]
    P = tables.shape[1]
    if k_pages.shape[2] != Kv or tables.shape[0] != B or lengths.shape != (B,):
        raise ValueError("shapes of q, pools, tables and lengths disagree")
    _check(q, k_pages, v_pages, tables, (("lengths", lengths),), G, hd, page, G)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = library().paged_decode_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, Kv, G, hd, page, P, int(window), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, DECODE)
    LAUNCHES[DECODE] += 1
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
) -> torch.Tensor:
    """K6 on the card. q (B, T, Kv, G, hd) pre-scaled; start, q_len (B,)
    int32 -> (B, T, Kv, G, hd) q.dtype (rows t >= q_len are garbage)."""
    B, T, Kv, G, hd = q.shape
    page = k_pages.shape[1]
    P = tables.shape[1]
    if (k_pages.shape[2] != Kv or tables.shape[0] != B
            or start.shape != (B,) or q_len.shape != (B,)):
        raise ValueError("shapes of q, pools, tables, start and q_len disagree")
    rows = min(PREFILL_ROWS, T * G)
    _check(q, k_pages, v_pages, tables, (("start", start), ("q_len", q_len)),
           G, hd, page, rows)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = library().paged_prefill_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            tables.data_ptr(), start.data_ptr(), q_len.data_ptr(),
            out.data_ptr(), B, T, Kv, G, hd, page, P, int(window), rows,
            _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, PREFILL)
    LAUNCHES[PREFILL] += 1
    return out
