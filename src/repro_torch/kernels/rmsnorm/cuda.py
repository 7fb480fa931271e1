"""ctypes wrappers of the two CUDA kernels in ``csrc/rmsnorm.cu``.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs (and K4's per-block partials) with ``torch.empty``, launches on the
current CUDA stream, raises when the C launcher returns a nonzero
``cudaGetLastError()``, and adds one to its entry of ``LAUNCHES`` — only
there, so a run can show that it went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build

SOURCE = "rmsnorm/csrc/rmsnorm.cu"
FWD = "rmsnorm_fwd"
BWD = "rmsnorm_bwd"
LAUNCHES: Dict[str, int] = {FWD: 0, BWD: 0}

BWD_BLOCKS = 264                  # K4's row blocks: 2 per SM of an H100
MAX_D = 12_288                    # K4's dscale partial lives in 48 KB of shared memory
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        lib.rmsnorm_fwd.argtypes = [_P] * 3 + [_I] * 2 + [_F, _I, _P]
        lib.rmsnorm_fwd.restype = _I
        lib.rmsnorm_bwd.argtypes = [_P] * 6 + [_I] * 3 + [_F, _I, _P]
        lib.rmsnorm_bwd.restype = _I
        lib._typed = True
    return lib


def _check(x: torch.Tensor, scale: torch.Tensor, *others: Tuple[str, torch.Tensor]):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {dev}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x dtype {x.dtype} not in {list(_DTYPES)}")
    if x.dim() != 2:
        raise ValueError(f"x must be (rows, d), got {tuple(x.shape)}")
    rows, d = x.shape
    if not 1 <= d <= MAX_D or rows < 1:
        raise ValueError(f"(rows, d) = {(rows, d)}: need rows >= 1, 1 <= d <= {MAX_D}")
    if scale.dtype != torch.float32 or scale.device != dev or scale.shape != (d,):
        raise TypeError(f"scale must be f32 ({d},) on {dev}")
    for name, t in others:
        if t.dtype != x.dtype or t.device != dev or t.shape != x.shape:
            raise TypeError(f"{name} must be {x.dtype} {tuple(x.shape)} on {dev}")
    for name, t in (("x", x), ("scale", scale)) + others:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return rows, d


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def rmsnorm_fwd_cuda(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """K3 on the card. x (rows, d) f32 or bf16; scale (d,) f32 -> x.dtype."""
    rows, d = _check(x, scale)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = library().rmsnorm_fwd(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d, float(eps),
            _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_on(err, FWD)
    LAUNCHES[FWD] += 1
    return out


def rmsnorm_bwd_cuda(
    x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, eps: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 on the card. Returns (dx (rows, d) x.dtype, dscale (d,) f32)."""
    rows, d = _check(x, scale, ("g", g))
    blocks = min(rows, BWD_BLOCKS)
    dx = torch.empty_like(x)
    partial = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    dscale = torch.empty((d,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = library().rmsnorm_bwd(
            x.data_ptr(), scale.data_ptr(), g.data_ptr(), dx.data_ptr(),
            partial.data_ptr(), dscale.data_ptr(), rows, d, blocks, float(eps),
            _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_on(err, BWD)
    LAUNCHES[BWD] += 1
    return dx, dscale
