"""The port's fused RMSNorm op (K3 forward, K4 backward) against the JAX
package's, on the CPU.

* Forward, dx and dscale of ``repro_torch.kernels.rmsnorm.rmsnorm`` (plain
  versions on a CPU tensor) against JAX's ``rmsnorm`` custom_vjp, whose
  Pallas kernels run in interpret mode here, at the shapes (8, 128),
  (2, 300, 64) and (1, 7, 96), in f32 and bf16, from the same numpy inputs.
* The plain backward written out equals autograd through the plain forward.
* The op takes the plain path for CPU tensors without touching the CUDA
  library, and the CUDA wrappers refuse CPU tensors.
* The CUDA wrappers' launch plan (pure Python): every width up to MAX_D
  lands on a body the source compiles, the scalar body runs for a d that no
  16-byte vector divides or a pointer off 16 bytes, the grid depends on the
  plan's arguments alone, and widths above MAX_D are refused.
The CUDA kernels themselves are held against the plain versions on the card
(chip_smoke.py, and the ``cuda``-marked test below).
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro_torch.kernels.rmsnorm import cuda, ops, ref, rmsnorm

SHAPES = [(8, 128), (2, 300, 64), (1, 7, 96)]
# f32: both sides compute in f32 and differ only in summation order and
# rsqrt rounding. bf16: x, out, g and dx are bf16, each side rounds its f32
# result once, so they may differ by one bf16 ulp (2**-8 relative); dscale
# stays f32 on both sides.
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=1e-2, rtol=1e-2)}
DSCALE_TOL = dict(atol=1e-4, rtol=1e-4)


def make(shape, seed):
    rng = np.random.RandomState(seed)
    d = shape[-1]
    x = rng.randn(*shape).astype(np.float32)
    scale = (1.0 + 0.1 * rng.randn(d)).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    return x, scale, g


def to_np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_rmsnorm_forward_and_grads_match_jax_pallas(shape, dtype):
    x, scale, g = make(shape, seed=sum(shape))
    jx = jnp.asarray(x, dtype)
    out_j, vjp = jax.vjp(lambda a, s: jax_rmsnorm(a, s), jx, jnp.asarray(scale))
    dx_j, ds_j = vjp(jnp.asarray(g, dtype))

    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    ts = torch.from_numpy(scale).requires_grad_(True)
    out = rmsnorm(tx, ts)
    dx, ds = torch.autograd.grad(out, (tx, ts), torch.from_numpy(g).to(tdt))
    assert out.dtype == tdt and dx.dtype == tdt and ds.dtype == torch.float32
    tol = TOL[dtype]
    np.testing.assert_allclose(to_np(out), np.asarray(out_j, np.float32), **tol)
    np.testing.assert_allclose(to_np(dx), np.asarray(dx_j, np.float32), **tol)
    np.testing.assert_allclose(to_np(ds), np.asarray(ds_j), **DSCALE_TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_plain_backward_equals_autograd_of_plain_forward(shape):
    # both in f32, the written-out formula associates differently: 1e-5
    x, scale, g = (torch.from_numpy(a) for a in make(shape, seed=3))
    x.requires_grad_(True)
    scale.requires_grad_(True)
    want = torch.autograd.grad(ref.rmsnorm_plain(x, scale), (x, scale), g)
    dx, ds = ref.rmsnorm_bwd_plain(x.detach(), scale.detach(), g)
    torch.testing.assert_close(dx, want[0], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(ds, want[1], atol=1e-5, rtol=1e-5)


def test_cpu_route_never_touches_cuda(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("CUDA path taken for a CPU tensor")

    for name in ("rmsnorm_fwd_cuda", "rmsnorm_bwd_cuda", "library"):
        monkeypatch.setattr(cuda, name, refuse)
    before = dict(cuda.LAUNCHES)
    x, scale, g = (torch.from_numpy(a) for a in make((4, 32), seed=1))
    x.requires_grad_(True)
    out = ops.rmsnorm(x, scale)
    out.backward(g)
    torch.testing.assert_close(out, ref.rmsnorm_plain(x, scale), atol=0, rtol=0)
    assert cuda.LAUNCHES == before


def test_cuda_wrappers_refuse_cpu_tensors():
    x, scale, g = (torch.from_numpy(a) for a in make((4, 32), seed=2))
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda.rmsnorm_fwd_cuda(x, scale)
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda.rmsnorm_bwd_cuda(x, scale, g)


PLAN_SHAPES = [(8192, 1152), (8192, 4096), (2048, 4096), (4, 4096), (128, 4096),
               (7, 100), (33, 1000), (5, 1001), (1, 7168), (3, 12_288), (601, 64), (1, 1)]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=[str(s) for s in PLAN_SHAPES])
def test_plan_covers_the_row_and_sizes_the_grid_from_its_arguments(shape, itemsize, aligned):
    rows, d = shape
    p = cuda.plan(rows, d, itemsize, aligned)
    # the row group covers d; one warp fewer would not, within the cap
    cap = cuda.NV_MAX[itemsize] if p.body == "vector" else cuda.SCALAR_NV
    assert 32 * p.wpr * p.nv * p.vec >= d > 32 * (p.wpr - 1) * cap * p.vec
    warps = p.wpr * p.per_block
    assert 32 * warps <= 512                        # the kernels' __launch_bounds__
    # a block holds at most 8 warps of rows, and no more rows than there are
    assert p.per_block == 1 or warps <= cuda.GROUP_WARPS
    assert p.per_block <= rows
    # every block has a row; the grid keeps at most WARPS_PER_SM warps on an
    # SM (or one block an SM), and gives every SM a block where rows allow
    groups = -(-rows // p.per_block)
    assert p.blocks <= groups
    assert -(-p.blocks // cuda.SMS) * warps <= max(cuda.WARPS_PER_SM, warps)
    assert p.blocks >= min(groups, cuda.SMS)
    # the plan depends on its arguments alone: plans of other shapes, sizes
    # and alignments made in between leave it as it was
    for r, w in PLAN_SHAPES:
        cuda.plan(r, w, 6 - itemsize, not aligned)
    assert cuda.plan(rows, d, itemsize, aligned) == p


@pytest.mark.parametrize("d,itemsize,aligned,body", [
    (100, 2, True, "scalar"), (100, 4, True, "vector"), (1001, 4, True, "scalar"),
    (7, 2, True, "scalar"), (1000, 2, True, "vector"), (1152, 2, True, "vector"),
    (1152, 2, False, "scalar"), (4096, 4, False, "scalar"), (12_288, 2, False, "scalar"),
])
def test_plan_takes_the_scalar_body_for_odd_d_or_a_pointer_off_16_bytes(
        d, itemsize, aligned, body):
    p = cuda.plan(4, d, itemsize, aligned)
    assert p.body == body
    assert p.vec == (1 if body == "scalar" else 16 // itemsize)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_plan_reaches_max_d_and_refuses_wider_rows(itemsize, aligned):
    p = cuda.plan(1, cuda.MAX_D, itemsize, aligned)
    assert 32 * p.wpr * p.nv * p.vec >= cuda.MAX_D >= 12_288
    for rows, d in ((1, cuda.MAX_D + 1), (0, 64), (4, 0)):
        with pytest.raises(ValueError, match="rows"):
            cuda.plan(rows, d, itemsize, aligned)


def test_every_width_lands_on_a_compiled_body():
    src = (Path(cuda.__file__).parent / "csrc" / "rmsnorm.cu").read_text()
    vector = {int(n) for n in re.findall(r"return F\(T, V16, (\d+)\)", src)}
    scalar = {int(n) for n in re.findall(r"return F\(T, 1, (\d+)\)", src)}
    assert vector == set(range(1, max(cuda.NV_MAX.values()) + 1))
    assert scalar == {cuda.SCALAR_NV}
    for itemsize in (2, 4):
        for aligned in (True, False):
            for d in range(1, cuda.MAX_D + 1):
                p = cuda.plan(3, d, itemsize, aligned)
                ok = (p.nv == cuda.SCALAR_NV if p.body == "scalar"
                      else 1 <= p.nv <= cuda.NV_MAX[itemsize])
                assert ok and 32 * p.wpr * p.nv * p.vec >= d, (d, itemsize, aligned, p)


def card_inputs(shape, dtype, seed, x_offset=0, scale_offset=0):
    """x, scale, g from ``make`` on the card; an offset puts x and g (or
    scale) that many elements into their buffer, off 16 bytes."""
    def at(a, dt, offset):
        buf = torch.empty(a.size + offset, dtype=dt, device="cuda")
        buf[offset:] = torch.from_numpy(a.reshape(-1)).to("cuda", dt)
        return buf[offset:].view(a.shape)

    x, scale, g = make(shape, seed)
    return at(x, dtype, x_offset), at(scale, torch.float32, scale_offset), at(g, dtype, x_offset)


# the JAX suite's shapes, gemma3-1b's width; d that no 16-byte vector divides,
# a predicated last sweep, one row, row groups left without a row, d 7168 and
# 12,288, serving's decode and prefill chunk, the pipe's microbatch; views at
# an odd storage offset (x and g, or scale)
CARD_CASES = [((8, 128), 0, 0), ((600, 64), 0, 0), ((7, 96), 0, 0), ((512, 1152), 0, 0),
              ((7, 100), 0, 0), ((33, 1000), 0, 0), ((5, 1001), 0, 0), ((3, 7), 0, 0),
              ((1, 1152), 0, 0), ((601, 64), 0, 0), ((5, 7168), 0, 0), ((3, 12_288), 0, 0),
              ((4, 4096), 0, 0), ((128, 4096), 0, 0), ((2048, 4096), 0, 0),
              ((64, 1152), 1, 0), ((4, 4096), 1, 0), ((64, 1152), 0, 1)]


@pytest.mark.cuda
def test_cuda_kernels_match_plain_on_the_card():
    """On an H100: K3 and K4 against their plain versions, f32 and bf16, in
    both bodies; dscale is the same bits from run to run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with python3 chip_smoke.py")
    for shape, xo, so in CARD_CASES:
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 1e-2)):
            x, scale, g = card_inputs(shape, dtype, 5, xo, so)
            torch.testing.assert_close(cuda.rmsnorm_fwd_cuda(x, scale),
                                       ref.rmsnorm_plain(x, scale), atol=tol, rtol=tol)
            dx, ds = cuda.rmsnorm_bwd_cuda(x, scale, g)
            pdx, pds = ref.rmsnorm_bwd_plain(x, scale, g)
            torch.testing.assert_close(dx, pdx, atol=tol, rtol=tol)
            torch.testing.assert_close(ds, pds, atol=1e-4, rtol=1e-4)
            assert torch.equal(ds, cuda.rmsnorm_bwd_cuda(x, scale, g)[1])
