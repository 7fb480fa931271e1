"""ctypes wrappers of the two CUDA kernels in ``csrc/blockwise_quant.cu``:
K8a (quantize) and K8b (dequantize).

Each wrapper checks device, dtype, shape, contiguity and alignment,
allocates its outputs with ``torch.empty``, launches on the current CUDA
stream, raises when the C launcher returns a nonzero ``cudaGetLastError()``,
and adds one to its entry of ``LAUNCHES`` — only there, so a run can show
that it went through the kernel. The code map and its midpoints are the
plain version's f32 tensors (``ref.code_table``), kept on each device once.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.blockwise_quant.ref import BLOCK, code_table

SOURCE = "blockwise_quant/csrc/blockwise_quant.cu"
QUANT = "blockwise_quantize"
DEQUANT = "blockwise_dequantize"
LAUNCHES: Dict[str, int] = {QUANT: 0, DEQUANT: 0}

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_TABLES: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        lib.blockwise_quantize.argtypes = [_P] * 4 + [_L, _P]
        lib.blockwise_quantize.restype = ctypes.c_int
        lib.blockwise_dequantize.argtypes = [_P] * 4 + [_L, _P]
        lib.blockwise_dequantize.restype = ctypes.c_int
        lib._typed = True
    return lib


def _tables(dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    if dev not in _TABLES:
        _TABLES[dev] = code_table(dev)
    return _TABLES[dev]


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, numel: int, dev,
           align: int) -> None:
    """``align``: the kernel reads or writes ``t`` in units of this many bytes
    (float4 for values, uchar4 for codes, float for scales)."""
    if t.device != dev or t.dtype != dtype or t.dim() != 1 or t.numel() != numel:
        raise TypeError(f"{name} must be {dtype} ({numel},) on {dev}, got "
                        f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name} must be contiguous and {align}-byte aligned")


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def quantize_cuda(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8a on the card. x flat f32 (n,), n % 256 == 0 -> (codes uint8 (n,),
    scales f32 (n / 256,))."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {dev}")
    n = x.numel()
    if n % BLOCK:
        raise ValueError(f"{n} values are not a multiple of the block {BLOCK}")
    _check("x", x, torch.float32, n, dev, 16)
    _, mid = _tables(dev)
    codes = torch.empty(n, dtype=torch.uint8, device=dev)
    scales = torch.empty(n // BLOCK, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = library().blockwise_quantize(
            x.data_ptr(), mid.data_ptr(), codes.data_ptr(), scales.data_ptr(),
            n // BLOCK, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, QUANT)
    LAUNCHES[QUANT] += 1
    return codes, scales


def dequantize_cuda(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """K8b on the card. codes uint8 (n,), scales f32 (n / 256,) -> f32 (n,)."""
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {dev}")
    n = codes.numel()
    if n % BLOCK:
        raise ValueError(f"{n} codes are not a multiple of the block {BLOCK}")
    _check("codes", codes, torch.uint8, n, dev, 4)
    _check("scales", scales, torch.float32, n // BLOCK, dev, 4)
    table, _ = _tables(dev)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = library().blockwise_dequantize(
            codes.data_ptr(), scales.data_ptr(), table.data_ptr(), out.data_ptr(),
            n // BLOCK, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, DEQUANT)
    LAUNCHES[DEQUANT] += 1
    return out
