"""The port's fused RMSNorm op (K3 forward, K4 backward) against the JAX
package's, on the CPU.

* Forward, dx and dscale of ``repro_torch.kernels.rmsnorm.rmsnorm`` (plain
  versions on a CPU tensor) against JAX's ``rmsnorm`` custom_vjp, whose
  Pallas kernels run in interpret mode here, at the shapes (8, 128),
  (2, 300, 64) and (1, 7, 96), in f32 and bf16, from the same numpy inputs.
* The plain backward written out equals autograd through the plain forward.
* The op takes the plain path for CPU tensors without touching the CUDA
  library, and the CUDA wrappers refuse CPU tensors.
The CUDA kernels themselves are held against the plain versions on the card
(chip_smoke.py, and the ``cuda``-marked test below).
"""
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


@pytest.mark.cuda
def test_cuda_kernels_match_plain_on_the_card():
    """On an H100: K3 and K4 against their plain versions, f32 and bf16;
    dscale is the same bits from run to run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with python3 chip_smoke.py")
    for shape in [(8, 128), (600, 64), (7, 96), (512, 1152)]:
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 1e-2)):
            x, scale, g = (torch.from_numpy(a).cuda() for a in make(shape, seed=5))
            x, g = x.to(dtype), g.to(dtype)
            torch.testing.assert_close(cuda.rmsnorm_fwd_cuda(x, scale),
                                       ref.rmsnorm_plain(x, scale), atol=tol, rtol=tol)
            dx, ds = cuda.rmsnorm_bwd_cuda(x, scale, g)
            pdx, pds = ref.rmsnorm_bwd_plain(x, scale, g)
            torch.testing.assert_close(dx, pdx, atol=tol, rtol=tol)
            torch.testing.assert_close(ds, pds, atol=1e-4, rtol=1e-4)
            assert torch.equal(ds, cuda.rmsnorm_bwd_cuda(x, scale, g)[1])
