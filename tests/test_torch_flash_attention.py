"""The port's flash-attention op (K1 forward, K2 backward) against the JAX
package's, on the CPU.

* The plain forward ``(o, lse)`` and dq/dk/dv of
  ``repro_torch.kernels.flash_attention`` against JAX's Pallas
  ``flash_attention_fwd_flat`` and ``flash_attention`` custom_vjp (interpret
  mode) on three of ``tests/test_kernels_backward.py``'s FA_CASES: the MQA
  G=4 case, the window case and the non-multiple S + window case.
* Output and dq/dk/dv against ``flash_attention_ref`` under ``jax.grad`` on
  all six FA_CASES, f32, 2e-5.
* A fully masked row (S > Sk with a window) gives zeros, a finite lse and
  finite grads, as the JAX kernel's does.
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

from repro.kernels.flash_attention.kernel import flash_attention_fwd_flat
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.flash_attention import cuda, flash_attention, ops, ref

# (B, S, Kv, G, hd, causal, window), as in tests/test_kernels_backward.py
FA_CASES = [
    (1, 128, 2, 1, 32, True, 0),     # MHA-style, block-aligned
    (2, 64, 1, 4, 16, True, 0),      # MQA, group accumulation over G=4
    (1, 128, 2, 2, 32, False, 0),    # non-causal
    (1, 128, 2, 2, 16, True, 32),    # sliding window
    (1, 130, 2, 2, 16, True, 0),     # non-multiple-of-block S
    (1, 250, 1, 2, 16, True, 64),    # non-multiple S + window
]
PALLAS_CASES = [FA_CASES[1], FA_CASES[3], FA_CASES[5]]
# f32 on both sides; the sums run in another order (whole rows here, 128-key
# blocks in the Pallas kernel)
TOL = dict(atol=2e-5, rtol=2e-5)
# the Pallas backward accumulates dq over k blocks and dk/dv over G x q
# blocks, each a further reordering of f32 sums (its own suite uses 1e-4)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def make(B, S, Kv, G, hd, seed, Sk=None):
    rng = np.random.RandomState(seed)
    Sk = S if Sk is None else Sk
    q = (rng.randn(B, S, Kv, G, hd) * hd ** -0.5).astype(np.float32)
    k = rng.randn(B, Sk, Kv, hd).astype(np.float32)
    v = rng.randn(B, Sk, Kv, hd).astype(np.float32)
    cot = rng.randn(B, S, Kv, G, hd).astype(np.float32)
    return q, k, v, cot


def port_out_and_grads(q, k, v, cot, causal, window):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = flash_attention(tq, tk, tv, causal, window)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(cot))
    return out.detach().numpy(), [g.numpy() for g in grads]


def jax_grads(fn, q, k, v, cot):
    return jax.jit(jax.grad(
        lambda a, b, c: jnp.sum(fn(a, b, c) * cot), argnums=(0, 1, 2)
    ))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


@pytest.mark.parametrize("case", FA_CASES, ids=[str(c) for c in FA_CASES])
def test_output_and_grads_match_jax_ref(case):
    B, S, Kv, G, hd, causal, window = case
    q, k, v, cot = make(B, S, Kv, G, hd, seed=sum(case[:5]))
    out, grads = port_out_and_grads(q, k, v, cot, causal, window)

    def f_ref(a, b, c):
        return flash_attention_ref(a, b, c, causal=causal, window=window)

    want = f_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out, np.asarray(want), **TOL)
    for name, a, b in zip("qkv", grads, jax_grads(f_ref, q, k, v, cot)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("case", PALLAS_CASES, ids=[str(c) for c in PALLAS_CASES])
def test_plain_fwd_lse_and_grads_match_jax_pallas(case):
    B, S, Kv, G, hd, causal, window = case
    q, k, v, cot = make(B, S, Kv, G, hd, seed=sum(case[:5]) + 1)
    qf, kf, vf = (ops._flatten_q(torch.from_numpy(q)),
                  ops._flatten_kv(torch.from_numpy(k)), ops._flatten_kv(torch.from_numpy(v)))
    o, lse = ref.flash_attention_fwd_plain(qf, kf, vf, group=G, causal=causal,
                                           window=window)
    jo, jlse = flash_attention_fwd_flat(
        jnp.asarray(qf.numpy()), jnp.asarray(kf.numpy()), jnp.asarray(vf.numpy()),
        group=G, causal=causal, window=window,
    )
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)

    out, grads = port_out_and_grads(q, k, v, cot, causal, window)
    jout = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, window)
    np.testing.assert_allclose(out, np.asarray(jout), **TOL)
    jg = jax_grads(lambda a, b, c: jax_flash(a, b, c, causal, window), q, k, v, cot)
    for name, a, b in zip("qkv", grads, jg):
        np.testing.assert_allclose(a, np.asarray(b), **GRAD_TOL, err_msg=f"d{name}")


def test_fully_masked_rows_give_zeros_and_no_nan():
    # S > Sk with a window: query rows i >= Sk + window - 1 see no key
    B, S, Sk, Kv, G, hd, window = 1, 48, 16, 1, 2, 16, 8
    q, k, v, cot = make(B, S, Kv, G, hd, seed=11, Sk=Sk)
    qf, kf, vf = (ops._flatten_q(torch.from_numpy(q)),
                  ops._flatten_kv(torch.from_numpy(k)), ops._flatten_kv(torch.from_numpy(v)))
    o, lse = ref.flash_attention_fwd_plain(qf, kf, vf, group=G, causal=True,
                                           window=window)
    dead = slice(Sk + window - 1, S)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert torch.equal(o[:, dead], torch.zeros_like(o[:, dead]))
    assert (lse[:, dead] < -1e29).all()
    jo, jlse = flash_attention_fwd_flat(
        jnp.asarray(qf.numpy()), jnp.asarray(kf.numpy()), jnp.asarray(vf.numpy()),
        group=G, causal=True, window=window,
    )
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-6)
    out, grads = port_out_and_grads(q, k, v, cot, True, window)
    assert all(np.isfinite(g).all() for g in grads)
    assert not grads[0][:, dead].any()          # dq of a dead row is exactly 0


def test_cpu_route_never_touches_cuda(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("CUDA path taken for a CPU tensor")

    for name in ("flash_attention_fwd_cuda", "flash_attention_bwd_cuda", "library"):
        monkeypatch.setattr(cuda, name, refuse)
    before = dict(cuda.LAUNCHES)
    q, k, v, cot = make(1, 32, 1, 2, 16, seed=4)
    out, grads = port_out_and_grads(q, k, v, cot, True, 0)
    assert out.shape == q.shape and [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    assert cuda.LAUNCHES == before


def test_cuda_wrappers_refuse_cpu_tensors():
    q, k, v, _ = (torch.from_numpy(a) for a in make(1, 32, 1, 2, 16, seed=5))
    qf, kf, vf = ops._flatten_q(q), ops._flatten_kv(k), ops._flatten_kv(v)
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda.flash_attention_fwd_cuda(qf, kf, vf, group=2)
    lse = torch.zeros(qf.shape[:2])
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda.flash_attention_bwd_cuda(qf, kf, vf, qf, lse, qf, group=2)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_on_the_card():
    """On an H100: K1 and K2 against their plain versions on every FA case
    (f32: forward 2e-5, gradients 1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with python3 chip_smoke.py")
    for B, S, Kv, G, hd, causal, window in FA_CASES:
        q, k, v, cot = (ops._flatten_q(torch.from_numpy(a)).cuda() if a.ndim == 5
                        else ops._flatten_kv(torch.from_numpy(a)).cuda()
                        for a in make(B, S, Kv, G, hd, seed=6))
        kw = dict(group=G, causal=causal, window=window)
        o, lse = cuda.flash_attention_fwd_cuda(q, k, v, **kw)
        po, plse = ref.flash_attention_fwd_plain(q, k, v, **kw)
        torch.testing.assert_close(o, po, **TOL)
        torch.testing.assert_close(lse, plse, **TOL)
        for a, b in zip(cuda.flash_attention_bwd_cuda(q, k, v, o, lse, cot, **kw),
                        ref.flash_attention_bwd_plain(q, k, v, po, plse, cot, **kw)):
            torch.testing.assert_close(a, b, **GRAD_TOL)
