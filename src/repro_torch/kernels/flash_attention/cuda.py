"""ctypes wrappers of the CUDA kernels in ``csrc/flash_attention.cu``: K1
(forward) and K2's three passes (delta, dq, dk/dv).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current CUDA stream, raises
when the C launcher returns a nonzero ``cudaGetLastError()``, and adds one
to its entry of ``LAUNCHES`` — only there, so a run can show that it went
through the kernel. ``flash_attention_bwd_cuda`` is K2 whole: its three
launches in order.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build

SOURCE = "flash_attention/csrc/flash_attention.cu"
FWD = "flash_attention_fwd"
DELTA = "flash_attention_bwd_delta"
DQ = "flash_attention_bwd_dq"
DKV = "flash_attention_bwd_dkv"
LAUNCHES: Dict[str, int] = {FWD: 0, DELTA: 0, DQ: 0, DKV: 0}

HEAD_DIMS = (16, 32, 64, 96, 128, 256)   # the head dims the source instantiates
MAX_SMEM_BYTES = 232_448             # dynamic shared memory one H100 block may use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        lib.flash_attention_fwd.argtypes = [_P] * 5 + [_I] * 8 + [_P]
        lib.flash_attention_fwd.restype = _I
        lib.flash_attention_bwd_delta.argtypes = [_P] * 3 + [_I] * 4 + [_P]
        lib.flash_attention_bwd_delta.restype = _I
        lib.flash_attention_bwd_dq.argtypes = [_P] * 7 + [_I] * 8 + [_P]
        lib.flash_attention_bwd_dq.restype = _I
        lib.flash_attention_bwd_dkv.argtypes = [_P] * 8 + [_I] * 8 + [_P]
        lib.flash_attention_bwd_dkv.restype = _I
        lib.flash_attention_smem_bytes.argtypes = [_I, _I]
        lib.flash_attention_smem_bytes.restype = ctypes.c_size_t
        lib._typed = True
    return lib


def _check(q, k, v, group, **extra) -> Tuple[int, int, int, int, int]:
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype} not in {list(_DTYPES)}")
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError("q must be (BH, S, hd) and k, v (BKv, Sk, hd)")
    BH, S, hd = q.shape
    BKv, Sk = k.shape[0], k.shape[1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if group < 1 or BH != BKv * group:
        raise ValueError(f"BH {BH} != BKv {BKv} x group {group}")
    if k.shape[2] != hd or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit q")
    if S < 1 or Sk < 1:
        raise ValueError("empty sequence")
    for name, t in (("k", k), ("v", v)) + tuple(extra.items()):
        want = torch.float32 if name in ("lse", "delta") else q.dtype
        if t.dtype != want or t.device != dev:
            raise TypeError(f"{name} must be {want} on {dev}")
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(extra.items()):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        # bf16 tiles are copied as 16-byte cp.async chunks
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for name, t in extra.items():
        want = (BH, S) if name in ("lse", "delta") else (BH, S, hd)
        if t.shape != want:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {want}")
    return BH, BKv, S, Sk, hd


def _smem_ok(pass_: int, hd: int) -> None:
    smem = library().flash_attention_smem_bytes(pass_, hd)
    if not 0 < smem <= MAX_SMEM_BYTES:
        raise ValueError(f"{smem} bytes of shared memory for hd {hd}: not in "
                         f"1..{MAX_SMEM_BYTES}")


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def flash_attention_fwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, group: int,
    causal: bool = True, window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on the card. Returns (o (BH, S, hd) q.dtype, lse (BH, S) f32)."""
    BH, BKv, S, Sk, hd = _check(q, k, v, group)
    _smem_ok(0, hd)
    o = torch.empty_like(q)
    lse = torch.empty((BH, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = library().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            BH, BKv, S, Sk, hd, int(causal), int(window), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, FWD)
    LAUNCHES[FWD] += 1
    return o, lse


def flash_attention_bwd_delta_cuda(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """K2's first launch: delta = rowsum(dO * O) in f32, (BH, S)."""
    if o.device.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {o.device}")
    if o.dtype not in _DTYPES or do.dtype != o.dtype or do.device != o.device:
        raise TypeError(f"o and do must share a dtype in {list(_DTYPES)} and a device")
    if o.dim() != 3 or do.shape != o.shape:
        raise ValueError(f"o {tuple(o.shape)} / do {tuple(do.shape)}: need equal (BH, S, hd)")
    if not (o.is_contiguous() and do.is_contiguous()):
        raise ValueError("o and do must be contiguous")
    BH, S, hd = o.shape
    delta = torch.empty((BH, S), dtype=torch.float32, device=o.device)
    with torch.cuda.device(o.device):
        err = library().flash_attention_bwd_delta(
            o.data_ptr(), do.data_ptr(), delta.data_ptr(), BH, S, hd, _DTYPES[o.dtype],
            torch.cuda.current_stream(o.device).cuda_stream,
        )
    _raise_on(err, DELTA)
    LAUNCHES[DELTA] += 1
    return delta


def flash_attention_bwd_dq_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, *, group: int, causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """K2's dq launch: one block per (head, q block) over the k blocks."""
    BH, BKv, S, Sk, hd = _check(q, k, v, group, do=do, lse=lse, delta=delta)
    _smem_ok(1, hd)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = library().flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), BH, BKv, S, Sk, hd, int(causal),
            int(window), _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, DQ)
    LAUNCHES[DQ] += 1
    return dq


def flash_attention_bwd_dkv_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, *, group: int, causal: bool = True,
    window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's dk/dv launch: one block per (kv head, k block), walking the G
    query heads times the q blocks."""
    BH, BKv, S, Sk, hd = _check(q, k, v, group, do=do, lse=lse, delta=delta)
    _smem_ok(2, hd)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = library().flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), BH, BKv, S, Sk, hd,
            int(causal), int(window), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, DKV)
    LAUNCHES[DKV] += 1
    return dk, dv


def flash_attention_bwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, *, group: int, causal: bool = True,
    window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 on the card: the delta, dq and dk/dv launches. Returns
    (dq q.dtype, dk k.dtype, dv v.dtype) in the flat layout."""
    _check(q, k, v, group, o=o, do=do, lse=lse)
    delta = flash_attention_bwd_delta_cuda(o, do)
    kw = dict(group=group, causal=causal, window=window)
    dq = flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv
