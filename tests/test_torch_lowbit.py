"""The port's low-bit optimizer state against the JAX package's, on the CPU
(plain versions of the K8 codec).

* Codec: the port's ``quantize`` / ``dequantize`` against JAX's, bitwise
  (codes, scales, dequantized values): against the Pallas kernel in
  interpret mode at n = 16,384, and against ``quantize_ref`` (which the JAX
  suite holds bitwise equal to the kernel) at more sizes, scales and
  paddings. The JAX suite's properties (zeros and padding, scale
  equivariance, |dequant| <= scale, round-trip error) on the port. The
  4-bit map and codec against ``repro.optim.lowbit4``.
* Layout: the state of ``adam8bit``, ``adam4bit`` and ``onebit_adam`` has
  JAX's keys, shapes and dtypes, per stacked JAX leaf: for a reduced
  gemma3-1b whose (24, 192) norm scales are quantized in blocks that
  straddle layers, and for the full gemma3-1b without allocating it (JAX
  through ``jax.eval_shape``, the port under ``FakeTensorMode``).
* One update from identical grads and state against JAX's jitted update.
* Three steps of ``fit`` per optimizer against JAX's
  ``make_train_step(mode="single")``.
* Checkpoints of ``adam8bit`` state both ways.
* The JAX suite's convergence and memory tests, run on the port.
* LARS and LAMB take their trust ratio over the stacked leaf, as JAX does.
The CUDA kernels are held against the plain versions on the card
(``chip_smoke.py``, and the ``cuda``-marked test below).
"""
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp_compat import hypothesis, st
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.checkpoint import ckpt as jckpt
from repro.checkpoint.ckpt import _flatten, _path_str
from repro.configs import get_config, get_reduced
from repro.data.pipeline import DataPipeline as JDataPipeline
from repro.kernels.blockwise_quant import dequantize as jdequantize
from repro.kernels.blockwise_quant import quantize as jquantize
from repro.kernels.blockwise_quant.ref import dynamic_map as jdynamic_map
from repro.models import init_params as jinit_params
from repro.optim import get as jget
from repro.optim import lowbit4 as jlowbit4
from repro.train.loop import TrainConfig as JTrainConfig
from repro.train.loop import make_state as jmake_state
from repro.train.loop import make_train_step as jmake_train_step
from repro_torch.checkpoint import ckpt, state_from_jax, state_to_numpy
from repro_torch.checkpoint.convert import leaves_to_flat, param_leaves, state_leaves
from repro_torch.checkpoint.convert import tensors_from_tree
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import get_reduced as t_get_reduced
from repro_torch.data import DataPipeline
from repro_torch.kernels.blockwise_quant import cuda, dequantize, dynamic_map, ops, quantize, ref
from repro_torch.optim import adam4bit, adam8bit, adamw, get, lowbit4, onebit_adam, state_bytes
from repro_torch.train import TrainConfig, fit, make_state

# pytest-xdist runs several workers on one machine: give torch this worker's share
# of the cores (oversubscribed, the torch side runs many times slower)
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

LR = 1e-3
STEPS = 3
OPTS = ["adam8bit", "adam4bit", "onebit_adam"]
# reduced gemma3-1b with 24 layers of width 192: the stacked norm scales are
# (24, 192) = 4,608 elements >= MIN_SIZE, so the low-bit optimizers quantize
# them, in 256-value blocks that straddle layers (192 % 256 != 0); per
# layer they would be 192 elements and stay f32
OVER = dict(n_layers=24, d_model=192, head_dim=48)
# onebit_adam switches to compression after 2 warm-up steps, so the third
# step of fit compresses
OPT_KW = {"adam8bit": {}, "adam4bit": {}, "onebit_adam": {"warmup_steps": 2}}
_NP = {torch.uint8: np.uint8, torch.float32: np.float32, torch.int32: np.int32}


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def npf32(n, scale=1.0, seed=0):
    return np.random.RandomState(seed).randn(n).astype(np.float32) * np.float32(scale)


def assert_codec_equal(x):
    """The port's codec on x against JAX's ``backend="ref"`` path, bitwise."""
    jc, js, jn = jquantize(jnp.asarray(x))
    c, s, n = quantize(torch.from_numpy(x))
    assert n == jn and c.dtype == torch.uint8 and s.dtype == torch.float32
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(dequantize(c, s, n, x.shape).numpy(),
                                  np.asarray(jdequantize(jc, js, jn, x.shape)))


# -------------------------------------------------------------------- codec
def test_dynamic_map_and_midpoints_are_the_references():
    m = dynamic_map()
    np.testing.assert_array_equal(m, jdynamic_map())
    assert m.shape == (256,) and np.all(np.diff(m) >= 0)
    assert m.max() == 1.0 and 0.0 in m and abs(m.min()) > 0.99
    codes, mid = ref.code_table("cpu")
    jcodes = jnp.asarray(jdynamic_map())
    np.testing.assert_array_equal(mid.numpy(), np.asarray((jcodes[1:] + jcodes[:-1]) / 2.0))


@pytest.mark.parametrize("scale", [1e-4, 1.0, 1e4])
def test_codec_matches_jax_pallas_kernel_bitwise(scale):
    """The JAX kernel in interpret mode at the JAX suite's smallest size."""
    x = npf32(256 * 64, scale)
    jc, js, _ = jquantize(jnp.asarray(x), backend="pallas")
    c, s, _ = quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    jd = jdequantize(jc, js, x.size, x.shape, backend="pallas")
    np.testing.assert_array_equal(dequantize(c, s, x.size, x.shape).numpy(), np.asarray(jd))


# the JAX suite's sizes, and sizes that need padding: a 100-element leaf,
# one past a 4096 leaf, one past a tile, and gemma3-1b's stacked norm scale
@pytest.mark.parametrize("n", [256 * 64, 256 * 64 * 4, 100, 4097, 16385, 26 * 1152])
@pytest.mark.parametrize("scale", [1e-4, 1.0, 1e4])
def test_codec_matches_jax_ref_bitwise(n, scale):
    assert_codec_equal(npf32(n, scale, seed=n))


def test_codec_handles_zeros_and_padding():
    x = np.zeros(100, np.float32)
    c, s, n = quantize(torch.from_numpy(x))
    assert c.shape == (256 * 64,) and s.shape == (64,) and n == 100
    assert float(s.abs().max()) == 0.0
    np.testing.assert_array_equal(dequantize(c, s, n, (100,)).numpy(), x)
    assert_codec_equal(x)


def test_codec_roundtrip_error_bound():
    x = torch.from_numpy(npf32(256 * 64, seed=1))
    c, s, n = quantize(x)
    xr = dequantize(c, s, n, x.shape)
    rel = float(torch.sqrt(torch.mean((x - xr) ** 2)) / torch.sqrt(torch.mean(x ** 2)))
    assert rel < 0.02, rel  # dynamic 8-bit: ~1% rms


@hypothesis.given(seed=st.integers(0, 50), exponent=st.integers(-40, 40))
@hypothesis.settings(max_examples=20, deadline=None)
def test_property_codec_scale_equivariant(seed, exponent):
    """quantize(a*x) has the codes of quantize(x) and a times its scales
    (per-block absmax normalizes). Exact for a power of two, which scales
    every value without rounding."""
    a = 2.0 ** exponent
    x = torch.from_numpy(npf32(256 * 64, seed=seed))
    c1, s1, _ = quantize(x)
    c2, s2, _ = quantize(x * a)
    assert torch.equal(c1, c2)
    assert torch.equal(s2, s1 * a)


@hypothesis.given(seed=st.integers(0, 50), logscale=st.floats(-6, 6))
@hypothesis.example(seed=10, logscale=3.5)
@hypothesis.settings(max_examples=20, deadline=None)
def test_property_codec_scale_equivariant_up_to_bin_edges(seed, logscale):
    """The JAX suite's property, with any scale: x*a rounds, so a value at a
    bin edge may take the neighbouring code (seed 10, a = 10**3.5 flips one
    of 16,384 codes, in the port and in JAX alike); the scales follow a to
    rounding."""
    a = float(10.0 ** logscale)
    x = torch.from_numpy(npf32(256 * 64, seed=seed))
    c1, s1, _ = quantize(x)
    c2, s2, _ = quantize(x * a)
    assert (c1 != c2).float().mean() <= 1e-3
    assert int((c1.int() - c2.int()).abs().max()) <= 1
    torch.testing.assert_close(s2, s1 * a, rtol=1e-5, atol=0)


@hypothesis.given(seed=st.integers(0, 50))
@hypothesis.settings(max_examples=15, deadline=None)
def test_property_dequant_bounded_by_scale(seed):
    x = torch.from_numpy(npf32(256 * 64, seed=seed))
    c, s, n = quantize(x)
    xr = dequantize(c, s, n, x.shape).reshape(-1, 256)
    assert bool((xr.abs() <= s[:, None] + 1e-6).all())


@pytest.mark.parametrize("scale", [1e-3, 1.0, 30.0])
def test_4bit_map_codec_and_grad_scale_match_jax(scale):
    np.testing.assert_array_equal(lowbit4.dynamic_map_4bit(), jlowbit4.dynamic_map_4bit())
    x = npf32(256 * 8, scale, seed=3)
    jc, js = jlowbit4.quantize4(jnp.asarray(x))
    c, s = lowbit4.quantize4(torch.from_numpy(x))
    assert int(c.max()) <= 15
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(lowbit4.dequantize4(c, s).numpy(),
                                  np.asarray(jlowbit4.dequantize4(jc, js)))
    # one mean over 2,048 squares, summed in another order: 1e-6
    np.testing.assert_allclose(float(lowbit4.grad_scale(torch.from_numpy(x))),
                               float(jlowbit4.grad_scale(jnp.asarray(x))), rtol=1e-6)


# ---------------------------------------- K8a's search and division, emulated
def kernel_search(v: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """K8a's index arithmetic (``csrc/blockwise_quant.cu::code_of``) in plain
    torch over the host's ``search_table``: the bits of |v| (or of the float
    below it when the sign bit is set), two steps on the 3 register
    midpoints, five in the padded table, the count mirrored for v < 0."""
    t = table.view(torch.int32).long()
    bits = v.contiguous().view(torch.int32).long()
    neg = -(bits < 0).long()                       # the kernel's bits >> 31
    w = (bits & 0x7FFFFFFF) + neg

    def at(m):
        return t[m + m // ref.SEARCH_PAD]

    s64 = (w >= at(63)).long()
    s32 = (w >= torch.where(s64 == 1, at(95), at(31))).long()
    pos = 64 * s64 + 32 * s32
    a = pos + pos // 32
    for step in (16, 8, 4, 2, 1):
        a = a + step * (t[a + step - 1] <= w).long()
    c = a - pos // 32 + ((neg == 0) & (w >= at(127))).long()
    return 127 + ((c ^ neg) - neg)


def test_search_table_layout_puts_each_step_in_distinct_banks():
    """P_m = mid[127 + m] at m + m // 32, +inf in the pads; the midpoints are
    mirrored below the top one; the candidates of the table's steps s = 16,
    8, 4, 2 fall in distinct banks (32 of 4 bytes) and those of s = 1 two to
    a bank."""
    _, mid = ref.code_table("cpu")
    table = ref.search_table("cpu")
    m = torch.arange(128)
    assert table.shape == (132,) and torch.equal(table[m + m // 32], mid[127:])
    assert torch.isinf(table[[32, 65, 98, 131]]).all()
    assert torch.equal(mid[:127], -mid[127:254].flip(0))
    for step, most in ((16, 1), (8, 1), (4, 1), (2, 1), (1, 2)):
        cand = torch.arange(0, 128, 2 * step) + step - 1
        banks = (cand + cand // 32) % 32
        assert int(torch.bincount(banks).max()) == most, step


def _search_inputs():
    _, mid = ref.code_table("cpu")
    near = [mid]
    for d in (1, 2):                                # two f32 neighbours a side
        for to in (2.0, -2.0):
            x = mid
            for _ in range(d):
                x = torch.nextafter(x, torch.full_like(x, to))
            near.append(x)
    tiny = torch.tensor([0.0, -0.0, 1.0, -1.0, 2.0**-149, -(2.0**-149), 2.0**-126,
                         -(2.0**-126), 1.1754942e-38, -1.1754942e-38, 1e-40, -1e-40])
    rng = np.random.RandomState(19)
    seeded = np.concatenate([rng.uniform(-1, 1, 500_000),
                             rng.choice([-1, 1], 500_000) * 10.0 ** rng.uniform(-9, 0, 500_000)])
    return {"midpoints": torch.cat(near), "zeros-ones-subnormals": tiny,
            "seeded": torch.tensor(seeded, dtype=torch.float32)}


@pytest.mark.parametrize("inputs", ["midpoints", "zeros-ones-subnormals", "seeded"])
def test_kernel_search_equals_searchsorted(inputs):
    v = _search_inputs()[inputs]
    _, mid = ref.code_table("cpu")
    want = torch.searchsorted(mid, v, right=True)
    assert torch.equal(kernel_search(v, ref.search_table("cpu")), want)


def _rn32_of_sum(a, b):
    """The f32 nearest (ties to even) to the exact a + b, a and b f64 with
    f32-sized terms: TwoSum, then the tail t decides a sum on an f32 tie."""
    s = a + b
    bb = s - a
    t = (a - (s - bb)) + (b - bb)
    f = s.astype(np.float32)
    ff = f.astype(np.float64)
    nb = np.nextafter(f, np.where(s > ff, np.float32(np.inf), np.float32(-np.inf))).astype(np.float64)
    tie = (s == (ff + nb) / 2) & (s != ff)
    out = f.copy()
    toward_nb = tie & (((t > 0) & (nb > ff)) | ((t < 0) & (nb < ff)))
    toward_f = tie & (((t > 0) & (nb < ff)) | ((t < 0) & (nb > ff)))
    out[toward_nb] = nb[toward_nb].astype(np.float32)
    out[toward_f] = f[toward_f]
    return out


def test_one_reciprocal_quotient_is_ieee_division():
    """K8a's and K7a's quotient for 2^-64 <= safe <= 2^64: r = RN(1 / safe),
    q0 = RN(x r), e = x - q0 safe (exact in f64, rounded once as the FMA
    does), q = RN(q0 + e r), against RN(x / safe) (f64 division rounded to
    f32 is correctly rounded), for |x| <= safe: every mantissa of safe in
    [1, 2), and seeded exponents of safe and x/safe."""
    rng = np.random.RandomState(7)
    n = 1 << 20
    safe = ((np.arange(n, dtype=np.uint32) * 8 % (1 << 23)) | (127 << 23)).view(np.float32)
    safe = (safe * np.exp2(rng.randint(-64, 64, n))).astype(np.float32)
    u = ((rng.randint(0, 1 << 23, n).astype(np.uint32))
         | (rng.randint(127 - 40, 128, n).astype(np.uint32) << 23)).view(np.float32)
    x = np.where(u >= 1, np.float32(1), u).astype(np.float32) * safe
    x = np.where(rng.rand(n) < 0.5, -x, x).astype(np.float32)
    r = (1.0 / safe.astype(np.float64)).astype(np.float32).astype(np.float64)
    q0 = (x.astype(np.float64) * r).astype(np.float32).astype(np.float64)
    e = (x.astype(np.float64) - q0 * safe.astype(np.float64)).astype(np.float32)
    q = _rn32_of_sum(q0, e.astype(np.float64) * r)
    want = (x.astype(np.float64) / safe.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(q, want)
    assert (q0.astype(np.float32) != want).any()    # the correction is needed


def test_cpu_route_never_touches_cuda(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("CUDA path taken for a CPU tensor")

    for name in ("quantize_cuda", "dequantize_cuda", "library"):
        monkeypatch.setattr(cuda, name, refuse)
    before = dict(cuda.LAUNCHES)
    x = torch.from_numpy(npf32(1000, seed=4))
    c, s, n = ops.quantize(x)
    ops.dequantize(c, s, n, x.shape)
    assert cuda.LAUNCHES == before


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros(256)
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda.quantize_cuda(x)
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda.dequantize_cuda(torch.zeros(256, dtype=torch.uint8), torch.zeros(1))


@pytest.mark.cuda
def test_cuda_codec_matches_plain_bitwise_on_the_card():
    """On an H100: K8a / K8b against their plain versions, bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with python3 chip_smoke.py")
    for n, scale in [(256 * 64, 1e-4), (256 * 64 * 4, 1e4), (256 * 3, 1.0), (256 * 4097, 1.0)]:
        x = torch.from_numpy(npf32(n, scale, seed=n)).cuda()
        c, s = cuda.quantize_cuda(x)
        pc, ps = ref.quantize_ref(x)
        assert torch.equal(c, pc) and torch.equal(s, ps)
        assert torch.equal(cuda.dequantize_cuda(c, s), ref.dequantize_ref(c, s))


# ------------------------------------------------------------------- layout
def jax_layout(cfg, name):
    """{key: (shape, dtype)} of JAX's optimizer state, without allocating it."""
    state = jax.eval_shape(lambda: jget(name, LR, **OPT_KW[name]).init(
        jinit_params(cfg, jax.random.PRNGKey(0))))
    return {"opt/" + "/".join(_path_str(p) for p in path): (tuple(leaf.shape), np.dtype(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]}


def port_layout(state):
    """{key: (shape, dtype)} of the port's optimizer state in the JAX layout
    (a per-layer tensor counts toward its stacked (L, ...) leaf)."""
    out, layers = {}, {}
    for key, t, i in state_leaves(state):
        if not key.startswith("opt/"):
            continue
        dt = np.dtype(_NP[t.dtype])
        if i is None:
            out[key] = (tuple(t.shape), dt)
        else:
            layers.setdefault(key, []).append(i)
            out[key] = ((len(layers[key]), *t.shape), dt)
    return out


@pytest.mark.parametrize("name", OPTS)
def test_state_layout_matches_jax_per_stacked_leaf(name):
    tcfg = t_get_reduced("gemma3-1b", **OVER)
    state = make_state(tcfg, get(name, LR, **OPT_KW[name]), TrainConfig(), device="cpu")
    got, want = port_layout(state), jax_layout(get_reduced("gemma3-1b", **OVER), name)
    assert got == want
    if name == "adam8bit":     # the (24, 192) norm scales are quantized, as in JAX
        assert got["opt/slots/stack/g0/p0/norm1/scale/m/codes"] == ((16384,), np.uint8)


@pytest.mark.parametrize("name", OPTS)
def test_state_layout_matches_jax_for_full_gemma3_1b(name):
    """Full width and depth, shapes only: the port's real ``make_state``
    under ``FakeTensorMode`` (no storage; the truncated-normal init, which
    reads its data, is skipped)."""
    with FakeTensorMode(allow_non_fake_inputs=True), \
            mock.patch("torch.nn.init.trunc_normal_", lambda w, *a, **k: w):
        state = make_state(t_get_config("gemma3-1b"), get(name, LR, **OPT_KW[name]),
                           TrainConfig(), device="cpu")
        got = port_layout(state)
        nbytes = state_bytes(state["opt"])
    assert got == jax_layout(get_config("gemma3-1b"), name)
    if name == "adam8bit":
        # codes 2 x 999,817,216 padded elements + scales 31,244,288 B + the
        # final norm's f32 m/v 9,216 B (+ the step), against AdamW's
        # 2 x 999,812,736 x 4 B of f32 m and v: 0.254x
        assert nbytes == 2_030_887_936 + 4
        assert got["opt/slots/stack/g0/p0/norm1/scale/m/codes"] == ((32768,), np.uint8)


# -------------------------------------------------------- one update vs JAX
def _update_case(name, seed):
    """A JAX training state of the reduced config, the port's copy of it,
    and grads of the params' shapes (numpy, log-uniform magnitudes)."""
    cfg, tcfg = get_reduced("gemma3-1b", **OVER), t_get_reduced("gemma3-1b", **OVER)
    jopt = jget(name, LR, **OPT_KW[name])
    jstate = jmake_state(cfg, jopt, JTrainConfig(), seed=seed)
    rng = np.random.RandomState(seed)
    grads = jax.tree.map(lambda p: (rng.randn(*p.shape) * 10.0 ** rng.uniform(-5, -1))
                         .astype(np.float32), numpy_tree(jstate["params"]))
    return cfg, tcfg, jopt, jstate, grads


def _port_update(name, tstate, grads):
    params = tstate["params"]
    tgrads = tensors_from_tree(params, grads, device="cpu")
    topt = get(name, LR, **OPT_KW[name])
    tu, topt_state = topt.update(tgrads, tstate["opt"], list(params.parameters()))
    return leaves_to_flat(param_leaves(params, tu)), dict(tstate, opt=topt_state)


def _opt_flat(state):
    return {k: v for k, v in _flatten(state_to_numpy(state)).items() if k.startswith("opt/")}


# one update: f32 on both sides; the bias corrections (f32 pow) and the
# update's divisions round alike, so updates agree to a few ulp of the
# largest (2e-6 of max |update|), except where a quantized moment differs
# by a code (the second update, below)
UPDATE_REL = 2e-6


@pytest.mark.parametrize("name", OPTS)
def test_first_update_matches_jax(name):
    """From the initial state the moments are (1-b1)*g and (1-b2)*g^2 on
    both sides (b1*0 rounds nothing), so the f32 moments fed to the codec
    are bitwise equal — asserted on the f32 moments — and so are the codes
    and scales, except the 4-bit m, whose GradScale is a mean summed in
    another order."""
    cfg, tcfg, jopt, jstate, grads = _update_case(name, seed=1)
    ju, jopt_state = jax.jit(jopt.update)(grads, jstate["opt"], jstate["params"])
    tstate = state_from_jax(numpy_tree(jstate), tcfg, device="cpu")
    tu, tstate = _port_update(name, tstate, grads)
    want_u = _flatten(numpy_tree(ju))
    for k, w in want_u.items():
        np.testing.assert_allclose(tu[k], w, atol=UPDATE_REL * np.abs(w).max(), rtol=0,
                                   err_msg=k)
    got = _opt_flat(tstate)
    want = _flatten(numpy_tree({"opt": jopt_state}))
    assert set(got) == set(want)
    moments = [k for k in want if k.split("/")[-1] in ("m", "v")
               or k.split("/")[1] in ("m", "v", "ef")]
    assert moments
    for k in moments:                                  # the f32 moments first
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in want:
        if k.endswith("/m4/codes"):
            assert (got[k] != want[k]).mean() <= 1e-3, k
        elif k.endswith("/gs") or k.endswith("/m4/scales"):
            # a mean of m^2 over the whole leaf (up to 2.6M terms) summed in
            # another order: 1e-5
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", OPTS)
def test_second_update_from_identical_state_matches_jax(name):
    """From JAX's state after one update, loaded into the port: JAX's jit
    fuses b1*m + (1-b1)*g into one FMA where the port rounds twice, so the
    moments differ by an ulp in some elements, a few codes flip at a bin
    edge (each moving its element by one code step), and 1-bit Adam's
    compression can give an element within roundoff of zero the other sign."""
    name_kw = dict(OPT_KW[name], warmup_steps=1) if name == "onebit_adam" else OPT_KW[name]
    cfg, tcfg, _, jstate, grads = _update_case(name, seed=2)
    jopt = jget(name, LR, **name_kw)
    _, jstate["opt"] = jax.jit(jopt.update)(grads, jstate["opt"], jstate["params"])
    tstate = state_from_jax(numpy_tree(jstate), tcfg, device="cpu")
    grads2 = jax.tree.map(lambda g: g[::-1].copy() * np.float32(0.5), grads)
    ju, jopt_state = jax.jit(jopt.update)(grads2, jstate["opt"], jstate["params"])
    params = tstate["params"]
    topt = get(name, LR, **name_kw)
    tu, topt_state = topt.update(tensors_from_tree(params, grads2, device="cpu"),
                                 tstate["opt"], list(params.parameters()))
    tu = leaves_to_flat(param_leaves(params, tu))
    got, want = _opt_flat(dict(tstate, opt=topt_state)), _flatten(numpy_tree({"opt": jopt_state}))
    assert set(got) == set(want)
    codes = [k for k in want if want[k].dtype == np.uint8]
    share = max([(got[k] != want[k]).mean() for k in codes], default=0.0)
    print(f"{name}: largest share of codes that differ from JAX's: {share:.2e}")
    assert share <= 1e-2, share
    for k, w in _flatten(numpy_tree(ju)).items():
        rel = np.linalg.norm(tu[k] - w) / np.linalg.norm(w)
        assert rel <= 1e-2, (k, rel)


# --------------------------------------------------------- three steps of fit
def _jax_run(name):
    cfg = get_reduced("gemma3-1b", **OVER)
    jtc = JTrainConfig(precision="f32", log_every=1)
    opt = jget(name, LR, **OPT_KW[name])
    state = jmake_state(cfg, opt, jtc, seed=0)
    init = numpy_tree(state)
    step = jmake_train_step(cfg, opt, jtc)
    data = JDataPipeline(cfg, 2, 128, seed=0)
    curve = []
    try:
        for _ in range(STEPS):
            state, m = step(state, {k: jnp.asarray(v) for k, v in next(data).items()})
            curve.append((float(m["loss"]), float(m["grad_norm"])))
    finally:
        data.close()
    return init, curve, _flatten(numpy_tree(state))


# per optimizer: (loss rtol, grad-norm rtol, params error as a share of
# their norm, f32 optimizer state error as a share of its norm, share of
# codes that may differ). Losses and grad norms are f32 and agree to ~1e-7
# and ~1e-5 (the third step sees params that moved by the two updates
# before it). JAX's jit rounds b1*m + (1-b1)*g once (FMA), the port twice,
# so after the first step ~0.1-0.3% of the codes differ by one (measured),
# each moving its element's moment by one code step; params then differ
# by ~3e-4 of their norm (8-bit) and ~1e-4 (4-bit), and scales and gs by
# ~5e-4. 1-bit Adam's compression step sends every element of a leaf to
# +-mean|m + ef|: an element within roundoff of zero may take the other
# sign (~1e-5 of the elements, measured), so m and ef differ by ~0.7% in
# norm and params by ~0.6%.
FIT_TOL = {
    "adam8bit": (1e-5, 1e-4, 1e-3, 2e-3, 1e-2),
    "adam4bit": (1e-5, 1e-4, 1e-3, 2e-3, 1e-2),
    "onebit_adam": (1e-5, 1e-4, 2e-2, 3e-2, 0.0),
}


@pytest.mark.parametrize("name", OPTS)
def test_three_steps_of_fit_match_jax(name):
    init, curve, final = _jax_run(name)
    tcfg = t_get_reduced("gemma3-1b", **OVER)
    state = state_from_jax(init, tcfg, device="cpu")
    tc = TrainConfig(precision="f32", log_every=1)
    data = DataPipeline(tcfg, 2, 128, seed=0)
    try:
        state, hist = fit(tcfg, tc, data, STEPS, get(name, LR, **OPT_KW[name]), state=state,
                          log=lambda line: None)
    finally:
        data.close()
    loss_rtol, gnorm_rtol, param_rel, state_rel, code_share = FIT_TOL[name]
    for h, (jl, jg) in zip(hist, curve):
        np.testing.assert_allclose(h["loss"], jl, rtol=loss_rtol)
        np.testing.assert_allclose(h["grad_norm"], jg, rtol=gnorm_rtol)
    got = _flatten(state_to_numpy(state))
    final = {k: v for k, v in final.items() if not k.startswith("comp")}
    assert set(got) == set(final)
    shares = {}
    for k, want in final.items():
        if want.dtype == np.uint8:
            shares[k] = float((got[k] != want).mean())
        elif want.dtype.kind != "f":
            np.testing.assert_array_equal(got[k], want, err_msg=k)
        else:
            err = np.abs(got[k] - want)
            rel = np.linalg.norm(err) / max(float(np.linalg.norm(want)), 1e-30)
            assert rel <= (param_rel if k.startswith("params/") else state_rel), (k, rel)
            if k.startswith("params/") and name != "onebit_adam":
                assert err.max() <= 2 * STEPS * LR, (k, err.max())
    if shares:
        print(f"{name}: share of codes that differ from JAX's after {STEPS} steps: "
              f"mean {np.mean(list(shares.values())):.2e}, max {max(shares.values()):.2e}")
        assert max(shares.values()) <= code_share, shares
    assert int(state["step"]) == STEPS


# -------------------------------------------------------------- checkpoints
def test_port_adam8bit_checkpoint_restores_in_jax(tmp_path):
    cfg, tcfg = get_reduced("gemma3-1b", **OVER), t_get_reduced("gemma3-1b", **OVER)
    tc = TrainConfig(log_every=1)
    opt = get("adam8bit", LR)
    state = make_state(tcfg, opt, tc, seed=1, device="cpu")
    data = DataPipeline(tcfg, 2, 32, seed=0)
    try:
        state, _ = fit(tcfg, tc, data, 2, opt, state=state, log=lambda s: None)
    finally:
        data.close()
    ckpt.save(str(tmp_path), 2, state)
    template = jmake_state(cfg, jget("adam8bit", LR), JTrainConfig(), seed=9)
    restored = _flatten(numpy_tree(jckpt.restore(str(tmp_path), template)))
    want = _flatten(state_to_numpy(state))
    restored = {k: v for k, v in restored.items() if not k.startswith("comp")}
    assert set(restored) == set(want)
    for k in want:
        assert restored[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(restored[k], want[k], err_msg=k)
    assert want["opt/slots/embed/table/m/codes"].dtype == np.uint8


def test_jax_adam8bit_checkpoint_restores_in_port(tmp_path):
    cfg, tcfg = get_reduced("gemma3-1b", **OVER), t_get_reduced("gemma3-1b", **OVER)
    jopt, jtc = jget("adam8bit", LR), JTrainConfig(log_every=1)
    jstate = jmake_state(cfg, jopt, jtc, seed=4)
    data = JDataPipeline(cfg, 2, 32, seed=0)
    try:
        jstate, _ = jmake_train_step(cfg, jopt, jtc)(
            jstate, {k: jnp.asarray(v) for k, v in next(data).items()})
    finally:
        data.close()
    jckpt.save(str(tmp_path), 1, jstate)
    state = make_state(tcfg, get("adam8bit", LR), TrainConfig(), seed=0, device="cpu")
    ckpt.restore(str(tmp_path), state)
    got, want = _flatten(state_to_numpy(state)), _flatten(numpy_tree(jstate))
    want = {k: v for k, v in want.items() if not k.startswith("comp")}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert state["opt"]["slots"][0]["m"]["codes"].dtype == torch.uint8
    # the restored state trains on
    data = DataPipeline(tcfg, 2, 32, seed=1)
    try:
        state, hist = fit(tcfg, TrainConfig(log_every=1), data, 1, get("adam8bit", LR),
                          state=state, log=lambda s: None)
    finally:
        data.close()
    assert np.isfinite(hist[0]["loss"]) and int(state["opt"]["step"]) == 2


# ------------------------------------- the JAX suite's optimizer tests, ported
def _regression(opt, steps, seed, shape):
    """The JAX suite's noisy linear regression: w (out, in) from zeros,
    batches of 32 from numpy. Returns (final loss, final w)."""
    rng = np.random.RandomState(seed)
    W = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    w = torch.zeros(shape, requires_grad=True)
    state = opt.init([w])
    losses = []
    for _ in range(steps):
        x = torch.from_numpy(rng.randn(32, shape[1]).astype(np.float32))
        y = x @ W.T
        loss = torch.mean((x @ w.T - y) ** 2)
        (g,) = torch.autograd.grad(loss, [w])
        upd, state = opt.update([g], state, [w])
        with torch.no_grad():
            w += upd[0]
            losses.append(float(torch.mean((x @ w.T - y) ** 2)))
    return losses, w.detach(), state


def test_adam8bit_tracks_adamw():
    """8-bit Adam should track f32 Adam closely on a noisy regression."""
    l8, w8, _ = _regression(adam8bit(1e-2), 60, 1, (128, 64))
    l32, w32, _ = _regression(adamw(1e-2), 60, 1, (128, 64))
    assert l8[-1] < 1.5 * l32[-1] + 1e-3, (l8[-1], l32[-1])
    rel = float(torch.linalg.norm(w8 - w32) / (torch.linalg.norm(w32) + 1e-9))
    assert rel < 0.15, rel


def test_adam8bit_state_is_4x_smaller():
    w = [torch.zeros(512, 512)]
    s8, s32 = adam8bit(1e-3).init(w), adamw(1e-3).init(w)
    b8, b32 = state_bytes(s8["slots"]), state_bytes({"m": s32["m"], "v": s32["v"]})
    assert b8 < 0.3 * b32, (b8, b32)  # 8-bit + scales ~ 0.26x


def test_adam4bit_tracks_adamw():
    l4, _, _ = _regression(adam4bit(1e-2), 50, 1, (128, 64))
    l32, _, _ = _regression(adamw(1e-2), 50, 1, (128, 64))
    assert l4[-1] < 3.0 * l32[-1] + 1e-2, (l4[-1], l32[-1])


def test_onebit_adam_loopback_converges():
    losses, _, state = _regression(onebit_adam(2e-2, warmup_steps=20), 120, 2, (96, 48))
    assert losses[-1] < 0.25 * losses[0], (losses[0], losses[-1])
    # the compression phase actually engaged
    assert int(state["step"]) > 20
    assert float(state["ef"][0].abs().sum()) > 0


def test_get_accepts_every_optimizer_of_the_reference():
    for name in ["sgd", "adamw", "lars", "lamb", "adam8bit", "adam4bit", "onebit_adam"]:
        state = get(name, 1e-3).init([torch.zeros(4096)])
        assert int(state["step"]) == 0


# ------------------------------------------------- LARS/LAMB per stacked leaf
@pytest.mark.parametrize("name", ["lars", "lamb"])
def test_trust_ratio_is_per_stacked_leaf(name):
    """The trust ratio ||w|| / ||update|| is over the whole (L, ...) leaf, as
    in JAX, not over each layer's tensor."""
    rng = np.random.RandomState(6)
    p = {"w": rng.randn(4, 8, 16).astype(np.float32), "b": rng.randn(16).astype(np.float32)}
    gs = [{k: rng.randn(*v.shape).astype(np.float32) * (1 + np.arange(v.shape[0]).reshape(
        (-1,) + (1,) * (v.ndim - 1))) for k, v in p.items()} for _ in range(2)]
    jopt = jget(name, 0.1)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    js = jopt.init(jp)
    tparams = [torch.from_numpy(p["b"].copy())] + [torch.from_numpy(p["w"][i].copy())
                                                   for i in range(4)]
    topt = get(name, 0.1)
    ts = topt.init(tparams, groups=[(0,), (1, 2, 3, 4)])
    for g in gs:
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = {k: jp[k] + ju[k] for k in jp}
        tg = [torch.from_numpy(g["b"])] + [torch.from_numpy(g["w"][i].copy()) for i in range(4)]
        tu, ts = topt.update(tg, ts, tparams)
        tparams = [a + u for a, u in zip(tparams, tu)]
    np.testing.assert_allclose(tparams[0].numpy(), np.asarray(jp["b"]), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(torch.stack(tparams[1:]).numpy(), np.asarray(jp["w"]),
                               atol=1e-6, rtol=1e-5)
