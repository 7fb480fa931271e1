"""ctypes wrappers of the two CUDA kernels in ``csrc/rmsnorm.cu``.

Each wrapper checks device, dtype, shape and contiguity, picks the launch
``plan`` (a pure function of the shape, the dtype and the pointers'
alignment), allocates its outputs (and K4's per-block partials) with
``torch.empty``, launches on the current CUDA stream, raises when the C
launcher returns a nonzero ``cudaGetLastError()``, and adds one to its entry
of ``LAUNCHES`` — only there, so a run can show that it went through the
kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import build

SOURCE = "rmsnorm/csrc/rmsnorm.cu"
FWD = "rmsnorm_fwd"
BWD = "rmsnorm_bwd"
LAUNCHES: Dict[str, int] = {FWD: 0, BWD: 0}

SMS = 132                         # an H100 SXM's streaming multiprocessors
WARPS_PER_SM = 16                 # resident warps a grid aims for (<= 128 registers each)
GROUP_WARPS = 8                   # a block's row groups fill 8 warps where they fit
# 16-byte slots a lane holds, at most: 40 bf16 or 24 f32 values, so that K4's
# x, g and dscale partial stay in registers
NV_MAX = {2: 5, 4: 6}             # by element size
SCALAR_NV = 24                    # the scalar body's one-value slots a lane (one instance)
MAX_D = 12_288                    # every body covers it: 16 warps x 32 lanes x 24 values
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class Plan(NamedTuple):
    """How a row kernel launches: ``vec`` values a slot (16 bytes, or 1 for
    the scalar body), ``nv`` slots a lane, ``wpr`` warps a row, ``per_block``
    rows a block at a time, ``blocks`` blocks."""
    vec: int
    nv: int
    wpr: int
    per_block: int
    blocks: int

    @property
    def body(self) -> str:
        return "scalar" if self.vec == 1 else "vector"


def plan(rows: int, d: int, itemsize: int, aligned: bool) -> Plan:
    """The launch plan of K3 and K4 for x (rows, d) of ``itemsize``-byte
    values. The 16-byte body needs d a multiple of its vector and
    ``aligned`` (x, g and scale on 16 bytes); else the scalar body runs,
    compiled once at ``SCALAR_NV`` slots a lane. The fewest warps a row
    whose lanes hold at most the cap, then the fewest slots a lane; a block
    holds up to 8 warps of rows (fewer where rows are too few to give each
    SM one), and the grid is at most the blocks that keep ``WARPS_PER_SM``
    warps on each of the ``SMS`` SMs. K4's order of additions follows the
    plan, so dscale's bits depend on (rows, d, itemsize, aligned): the same
    values at another storage offset may sum in another order."""
    if not 1 <= d <= MAX_D or rows < 1:
        raise ValueError(f"(rows, d) = {(rows, d)}: need rows >= 1, 1 <= d <= {MAX_D}")
    vec = 16 // itemsize
    if aligned and d % vec == 0:
        nv_max = NV_MAX[itemsize]
    else:
        vec, nv_max = 1, SCALAR_NV
    slots = d // vec
    wpr = -(-slots // (32 * nv_max))
    nv = -(-slots // (32 * wpr)) if vec > 1 else SCALAR_NV
    per_block = max(1, min(GROUP_WARPS // wpr, -(-rows // SMS)))
    warps = wpr * per_block
    blocks = min(-(-rows // per_block), SMS * max(1, WARPS_PER_SM // warps))
    return Plan(vec, nv, wpr, per_block, blocks)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        lib.rmsnorm_fwd.argtypes = [_P] * 3 + [_I] * 2 + [_F] + [_I] * 6 + [_P]
        lib.rmsnorm_fwd.restype = _I
        lib.rmsnorm_bwd.argtypes = [_P] * 6 + [_I] * 2 + [_F] + [_I] * 6 + [_P]
        lib.rmsnorm_bwd.restype = _I
        lib._typed = True
    return lib


def _check(x: torch.Tensor, scale: torch.Tensor, *others: Tuple[str, torch.Tensor]):
    """(rows, d) and the plan, after checking every argument."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given a tensor on {dev}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x dtype {x.dtype} not in {list(_DTYPES)}")
    if x.dim() != 2:
        raise ValueError(f"x must be (rows, d), got {tuple(x.shape)}")
    rows, d = x.shape
    if scale.dtype != torch.float32 or scale.device != dev or scale.shape != (d,):
        raise TypeError(f"scale must be f32 ({d},) on {dev}")
    for name, t in others:
        if t.dtype != x.dtype or t.device != dev or t.shape != x.shape:
            raise TypeError(f"{name} must be {x.dtype} {tuple(x.shape)} on {dev}")
    inputs = (("x", x), ("scale", scale)) + others
    for name, t in inputs:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    aligned = all(t.data_ptr() % 16 == 0 for _, t in inputs)
    return rows, d, plan(rows, d, x.element_size(), aligned)


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def rmsnorm_fwd_cuda(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """K3 on the card. x (rows, d) f32 or bf16; scale (d,) f32 -> x.dtype."""
    rows, d, p = _check(x, scale)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = library().rmsnorm_fwd(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d, float(eps),
            _DTYPES[x.dtype], *p, torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_on(err, FWD)
    LAUNCHES[FWD] += 1
    return out


def rmsnorm_bwd_cuda(
    x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, eps: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 on the card. Returns (dx (rows, d) x.dtype, dscale (d,) f32)."""
    rows, d, p = _check(x, scale, ("g", g))
    dx = torch.empty_like(x)
    partial = torch.empty((p.blocks, d), dtype=torch.float32, device=x.device)
    dscale = torch.empty((d,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = library().rmsnorm_bwd(
            x.data_ptr(), scale.data_ptr(), g.data_ptr(), dx.data_ptr(),
            partial.data_ptr(), dscale.data_ptr(), rows, d, float(eps),
            _DTYPES[x.dtype], *p, torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_on(err, BWD)
    LAUNCHES[BWD] += 1
    return dx, dscale
