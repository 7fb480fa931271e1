"""ctypes wrappers of the CUDA kernels in ``csrc/blockwise_quant.cu``: K8a /
K8b (the dynamic 8-bit quantize / dequantize of the low-bit optimizers) and
K7a / K7b (the symmetric int8 / fp8 codec of the pipeline's activation
stash).

Each wrapper checks device, dtype, shape, contiguity and alignment,
allocates its outputs with ``torch.empty``, launches on the current CUDA
stream, raises when the C launcher returns a nonzero ``cudaGetLastError()``,
and adds one to its entry of ``LAUNCHES`` — only there, so a run can show
that it went through the kernel. The code map is the plain version's f32
tensor (``ref.code_table``), and K8a's midpoints are laid out for its search
(``ref.search_table``), both kept on each device once.
K7a takes the buffers to write into, so a stash slot's rows are filled in
place with no copy.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.blockwise_quant.ref import BLOCK, code_table, search_table

SOURCE = "blockwise_quant/csrc/blockwise_quant.cu"
QUANT = "blockwise_quantize"
DEQUANT = "blockwise_dequantize"
STASH_QUANT = "stash_quantize"
STASH_DEQUANT = "stash_dequantize"
LAUNCHES: Dict[str, int] = {QUANT: 0, DEQUANT: 0, STASH_QUANT: 0, STASH_DEQUANT: 0}
# K7's value dtypes (input of K7a, output of K7b) and storage dtypes
STASH_VALUES = (torch.float32, torch.bfloat16)
STASH_STORAGE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_I = ctypes.c_int
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
        lib.stash_quantize.argtypes = [_P, _I, _P, _I, _P, _L, _P]
        lib.stash_quantize.restype = ctypes.c_int
        lib.stash_dequantize.argtypes = [_P, _I, _P, _P, _I, _L, _P]
        lib.stash_dequantize.restype = ctypes.c_int
        lib._typed = True
    return lib


def _tables(dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(code map, K8a's search table) on ``dev``."""
    if dev not in _TABLES:
        _TABLES[dev] = (code_table(dev)[0], search_table(dev))
    return _TABLES[dev]


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: Sequence[int], dev,
           align: int) -> None:
    """``align``: the kernel reads or writes ``t`` in units of this many bytes
    (16-byte vectors of values, 4, 8 or 16 bytes of codes, a float for
    scales)."""
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise TypeError(f"{name} must be {dtype} {tuple(shape)} on {dev}, got "
                        f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name} must be contiguous and {align}-byte aligned")


def _on_card(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {t.device}")
    return t.device


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def quantize_cuda(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8a on the card. x flat f32 (n,), n % 256 == 0 -> (codes uint8 (n,),
    scales f32 (n / 256,))."""
    dev = _on_card(x)
    n = x.numel()
    if n % BLOCK:
        raise ValueError(f"{n} values are not a multiple of the block {BLOCK}")
    _check("x", x, torch.float32, (n,), dev, 16)
    _, search = _tables(dev)
    codes = torch.empty(n, dtype=torch.uint8, device=dev)
    scales = torch.empty(n // BLOCK, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = library().blockwise_quantize(
            x.data_ptr(), search.data_ptr(), codes.data_ptr(), scales.data_ptr(),
            n // BLOCK, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, QUANT)
    LAUNCHES[QUANT] += 1
    return codes, scales


def dequantize_cuda(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """K8b on the card. codes uint8 (n,), scales f32 (n / 256,) -> f32 (n,)."""
    dev = _on_card(codes)
    n = codes.numel()
    if n % BLOCK:
        raise ValueError(f"{n} codes are not a multiple of the block {BLOCK}")
    _check("codes", codes, torch.uint8, (n,), dev, 4)
    _check("scales", scales, torch.float32, (n // BLOCK,), dev, 4)
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


def stash_quantize_cuda(
    x: torch.Tensor, storage: str, codes: Optional[torch.Tensor] = None,
    scales: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7a on the card. x flat f32 or bf16 (n,), n % 256 == 0 -> (codes
    (n / 256, 256) int8 or float8_e4m3fn, scales (n / 256,) f32), written
    into ``codes`` / ``scales`` when they are given."""
    dev = _on_card(x)
    if storage not in STASH_STORAGE:
        raise ValueError(f"stash storage {storage!r} not in {tuple(STASH_STORAGE)}")
    if x.dtype not in STASH_VALUES:
        raise TypeError(f"K7a takes {STASH_VALUES}, got {x.dtype}")
    n = x.numel()
    if n % BLOCK:
        raise ValueError(f"{n} values are not a multiple of the block {BLOCK}")
    nb = n // BLOCK
    sdt = STASH_STORAGE[storage]
    if codes is None:
        codes = torch.empty(nb, BLOCK, dtype=sdt, device=dev)
    if scales is None:
        scales = torch.empty(nb, dtype=torch.float32, device=dev)
    _check("x", x, x.dtype, (n,), dev, 16)
    _check("codes", codes, sdt, (nb, BLOCK), dev, 16)
    _check("scales", scales, torch.float32, (nb,), dev, 4)
    with torch.cuda.device(dev):
        err = library().stash_quantize(
            x.data_ptr(), int(x.dtype == torch.bfloat16), codes.data_ptr(),
            int(storage == "fp8"), scales.data_ptr(), nb,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, STASH_QUANT)
    LAUNCHES[STASH_QUANT] += 1
    return codes, scales


def stash_dequantize_cuda(
    codes: torch.Tensor, scales: torch.Tensor, dtype: torch.dtype,
) -> torch.Tensor:
    """K7b on the card. codes (nb, 256) int8 or float8_e4m3fn, scales (nb,)
    f32 -> (nb, 256) ``dtype`` (f32 or bf16)."""
    dev = _on_card(codes)
    fp8 = codes.dtype == torch.float8_e4m3fn
    if codes.dtype not in STASH_STORAGE.values():
        raise TypeError(f"K7b takes int8 or float8_e4m3fn codes, got {codes.dtype}")
    if dtype not in STASH_VALUES:
        raise TypeError(f"K7b writes {STASH_VALUES}, got {dtype}")
    nb = codes.shape[0]
    _check("codes", codes, codes.dtype, (nb, BLOCK), dev, 8)
    _check("scales", scales, torch.float32, (nb,), dev, 4)
    out = torch.empty(nb, BLOCK, dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        err = library().stash_dequantize(
            codes.data_ptr(), int(fp8), scales.data_ptr(), out.data_ptr(),
            int(dtype == torch.bfloat16), nb, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, STASH_DEQUANT)
    LAUNCHES[STASH_DEQUANT] += 1
    return out
