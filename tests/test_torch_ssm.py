"""The port's SSM family (falcon-mamba-7b, Mamba-1) against the JAX package,
on the CPU, at reduced size (2 layers, d 256, d_inner 512, state 16, conv
4, vocabulary 1,024).

* The block (layer 0's mixer, carried across by ``params_from_jax``):
  ``_causal_conv`` and ``_ssm_coeffs``, and ``mamba_apply`` with its
  collected decode state, by the associative and the chunked scan, at S 1,
  2 (under K - 1: the conv state is left-padded), 37 and 64. f32 within
  1e-5 of max|ref|; bf16 within one bf16 ulp in at least 99% of the
  elements, against JAX compiled without excess precision (each bf16 step
  rounded, as the program says). A chain of ``mamba_decode`` steps and their
  states.
* The converter round-trips the tree bitwise (nested and flat) and stores
  the matmuls and ``conv_w`` at the compute dtype, the SSM vectors in f32.
* The model in f32: ``forward``'s logits and ``loss_fn`` (dense and
  chunked-CE heads); ``prefill`` then four ``decode_step``s, logits and
  every layer's ``conv``/``ssm`` state, at a prompt under K - 1 too.
* Serving: greedy ``train.serve.generate`` tokens identical to JAX's, and
  ``ServeEngine`` (``paged=None``: the dense fallback) identical to JAX's
  dense-fallback engine, with JAX's ``kv_bytes``; a ``kv_dtype`` changes
  nothing; ``paged=True``, ``generate(paged=True)``, pool pricing and a
  paged pool refuse the family; its pipeline stage raises, naming ROADMAP
  item 7; the launcher serves it on the CPU.

The JAX side compiles each program once (module fixtures and one
``compiled`` per shape, XLA's backend optimisation off).
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _flatten
from repro.configs import get_reduced
from repro.models import Runtime, init_params
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import loss_fn as jloss_fn
from repro.models import prefill as jprefill
from repro.models import ssm as jssm
from repro.models.stack import layer_specs as jlayer_specs
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve.engine import dense_kv_bytes as jdense_kv_bytes
from repro.train.serve import generate as jgenerate
from repro_torch.checkpoint import params_from_jax, params_to_numpy
from repro_torch.configs import get_reduced as t_get_reduced
from repro_torch.launch import serve as launch_serve
from repro_torch.models import Runtime as TRuntime
from repro_torch.models import decode_step as tdecode_step
from repro_torch.models import forward as tforward
from repro_torch.models import init_decode_state, pipeline_fns
from repro_torch.models import init_params as tinit_params
from repro_torch.models import loss_fn as tloss_fn
from repro_torch.models import prefill as tprefill
from repro_torch.models import ssm as tssm
from repro_torch.models.stack import init_stack_pool, layer_specs
from repro_torch.serve import EngineConfig, ServeEngine
from repro_torch.train.serve import generate
from test_torch_serve_whole import jax_layers

# pytest-xdist runs several workers on one machine: give torch this worker's share
# of the cores (oversubscribed, the torch side runs many times slower)
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

ARCH = "falcon-mamba-7b"
RT = Runtime(dtype=jnp.float32)
TRT = TRuntime(dtype=torch.float32)
TOL = 1e-5                       # of max|ref|: f32 on both sides, sums in another order
MODEL_TOL = 2e-5                 # the model's logits and states, f32
BF16_SHARE = 0.99                # bf16: elements within one ulp of JAX's
LENGTHS = (9, 2, 9)              # two prompts of one length batch in the dense engine
NEW = 6
CHUNK = {1: 1, 2: 1, 37: 37, 64: 16}   # the chunked scan's chunk at each S


@pytest.fixture(scope="module")
def model():
    cfg, tcfg = get_reduced(ARCH), t_get_reduced(ARCH)
    params = compiled(lambda k: init_params(cfg, k), jax.random.PRNGKey(0))(
        jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    return cfg, params, tcfg, params_from_jax(tree, tcfg, device="cpu"), tree


@pytest.fixture(scope="module")
def mixers(model):
    """Layer 0's mixer: the JAX leaves, and the port's at f32 and bf16."""
    cfg, _, tcfg, _, tree = model
    p = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["stack"]["g0"]["p0"]["mixer"])
    tp = {dt: params_from_jax(tree, tcfg, device="cpu", dtype=dt).stack.layers[0].mixer
          for dt in (torch.float32, torch.bfloat16)}
    return p, tp


def compiled(fn, *args):
    """``fn`` jitted for ``args``' shapes, with XLA's backend optimisation
    off and without excess precision (each bf16 result rounded to bf16, as
    the program and JAX run op by op do)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0,
                          "xla_allow_excess_precision": False})


def jdt(dtype):
    return jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32


def inputs(S, d, dtype, seed=0):
    x = np.random.RandomState(seed + S).randn(2, S, d).astype(np.float32)
    return jnp.asarray(x).astype(jdt(dtype)), torch.from_numpy(x).to(dtype)


def assert_agrees(got, want, dtype, what):
    """f32: within TOL of max|want|; bf16: within one bf16 ulp (2**-7 of the
    larger magnitude) in at least BF16_SHARE of the elements."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if dtype == torch.float32:
        err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
        assert err <= TOL, (what, err)
        return
    bound = 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want))
    share = float(np.mean(np.abs(got - want) <= bound))
    assert share >= BF16_SHARE, (what, share)


DTYPES = [torch.float32, torch.bfloat16]
DT_IDS = ["f32", "bf16"]


# --------------------------------------------------------------------- block
@pytest.mark.parametrize("S", sorted(CHUNK))
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_causal_conv_and_ssm_coeffs_match_jax(mixers, S, dtype):
    """The conv's unrolled adds at the compute dtype, then the f32 (a, b)
    and the readout C from the conv's silu."""
    p, tps = mixers
    tp = tps[dtype]
    di = p["conv_w"].shape[1]
    x, tx = inputs(S, di, dtype)

    def jfn(p_, x_):
        conv = jssm._causal_conv(x_, p_["conv_w"].astype(x_.dtype), p_["conv_b"])
        return (conv,) + jssm._ssm_coeffs(p_, jax.nn.silu(conv))

    want = compiled(jfn, p, x)(p, x)
    conv = tssm._causal_conv(tx, tp.conv_w.to(dtype), tp.conv_b)
    got = (conv,) + tssm._ssm_coeffs(tp, tssm.silu(conv))
    assert got[1].dtype == got[2].dtype == torch.float32
    for name, g, w in zip(("conv", "a", "b", "C"), got, want):
        assert_agrees(g, w, dtype, f"{name} S={S}")


@pytest.mark.parametrize("S", sorted(CHUNK))
@pytest.mark.parametrize("mode", ["assoc", "chunked"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_mamba_apply_and_state_match_jax(mixers, S, mode, dtype):
    """The block's output and its collected state (the conv's last K - 1
    inputs, left-padded under K - 1; h after the last position)."""
    p, tps = mixers
    d = p["in_proj"].shape[0]
    x, tx = inputs(S, d, dtype, seed=1)
    kw = dict(scan_mode=mode, chunk=CHUNK[S], collect_state=True)
    want, wst = compiled(functools.partial(jssm.mamba_apply, **kw), p, x)(p, x)
    got, gst = tssm.mamba_apply(tps[dtype], tx, **kw)
    assert got.dtype == dtype and gst["conv"].dtype == dtype
    assert gst["ssm"].dtype == torch.float32
    assert gst["conv"].shape == (2, 3, p["conv_w"].shape[1])
    assert_agrees(got, want, dtype, f"out S={S}")
    for k in ("conv", "ssm"):
        assert_agrees(gst[k], wst[k], dtype, f"{k} S={S}")
    if S < 3:
        assert not gst["conv"][:, : 3 - S].any()


def test_assoc_scan_pairs_like_jax():
    """The scan alone over odd and even lengths, at f32: the products and
    the sums within 1e-6 of max|ref| of ``jax.lax.associative_scan``'s."""
    def combine(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

    for S in (1, 2, 3, 5, 8, 13, 64):
        rng = np.random.RandomState(S)
        a = rng.uniform(0.5, 1.0, (2, S, 3, 4)).astype(np.float32)
        b = rng.randn(2, S, 3, 4).astype(np.float32)
        ab = (jnp.asarray(a), jnp.asarray(b))
        wa, wb = compiled(lambda x: jax.lax.associative_scan(combine, x, axis=1), ab)(ab)
        ga, gb = tssm.assoc_scan(torch.from_numpy(a), torch.from_numpy(b))
        for g, w in ((ga, wa), (gb, wb)):
            w = np.asarray(w)
            assert float(np.abs(g.numpy() - w).max()) <= 1e-6 * float(np.abs(w).max()), S


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_mamba_decode_chain_matches_jax(mixers, dtype):
    """A 5-token prefix's collected state, then four recurrent steps: each
    step's output and the state it leaves."""
    p, tps = mixers
    tp = tps[dtype]
    d = p["in_proj"].shape[0]
    x, tx = inputs(9, d, dtype, seed=2)
    _, wst = compiled(functools.partial(jssm.mamba_apply, collect_state=True),
                      p, x[:, :5])(p, x[:, :5])
    _, gst = tssm.mamba_apply(tp, tx[:, :5], collect_state=True)
    jstep = compiled(jssm.mamba_decode, p, x[:, 5:6], wst)
    for t in range(5, 9):
        want, wst = jstep(p, x[:, t: t + 1], wst)
        got, gst = tssm.mamba_decode(tp, tx[:, t: t + 1], gst)
        assert_agrees(got, want, dtype, f"out t={t}")
        for k in ("conv", "ssm"):
            assert_agrees(gst[k], wst[k], dtype, f"{k} t={t}")


def test_init_mamba_state_matches_jax(mixers):
    p, tps = mixers
    want = jssm.init_mamba_state(p, 3, jnp.bfloat16)
    got = tssm.init_mamba_state(tps[torch.bfloat16], 3, torch.bfloat16)
    assert got["conv"].dtype == torch.bfloat16 and got["ssm"].dtype == torch.float32
    for k in ("conv", "ssm"):
        assert tuple(got[k].shape) == want[k].shape and not got[k].any()


# ----------------------------------------------------------------- converter
def test_params_from_jax_round_trips_nested_and_flat(model):
    cfg, _, tcfg, tparams, tree = model
    flat = _flatten(tree)
    assert "stack/g0/p0/mixer/A_log" in flat and "stack/g0/p0/norm2/scale" not in flat
    b = params_from_jax(flat, tcfg, device="cpu")
    for got in (params_to_numpy(tparams), params_to_numpy(b)):
        got = _flatten(got)
        assert set(got) == set(flat)
        for k, v in flat.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    layer = tparams.stack.layers[0]
    assert layer.norm2 is None and layer.ffn is None and len(tparams.stack.layers) == 2


def test_params_from_jax_stores_ssm_leaves_by_role(model):
    """Matmuls and conv_w at the compute dtype (JAX casts them at each use);
    conv_b, dt_bias, A_log and D in f32 (JAX reads them in f32)."""
    _, _, tcfg, _, tree = model
    m = params_from_jax(tree, tcfg, device="cpu", dtype=torch.bfloat16).stack.layers[1].mixer
    for k in ("in_proj", "conv_w", "x_proj", "dt_proj", "out_proj"):
        assert getattr(m, k).dtype == torch.bfloat16, k
    for k in ("conv_b", "dt_bias", "A_log", "D"):
        assert getattr(m, k).dtype == torch.float32, k


def test_init_params_tree_and_distributions_match_jax(model):
    cfg, _, tcfg, _, tree = model
    want = _flatten(tree)
    got = _flatten(params_to_numpy(tinit_params(tcfg, seed=0, device="cpu",
                                                dtype=torch.float32)))
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    for k in ("A_log", "D", "conv_b"):       # A_log: two libraries' log, an ulp apart
        key = f"stack/g0/p0/mixer/{k}"
        np.testing.assert_allclose(got[key], want[key], rtol=2e-7, atol=0, err_msg=k)
    dt = np.log1p(np.exp(got["stack/g0/p0/mixer/dt_bias"]))     # softplus
    assert dt.min() >= 1e-3 - 1e-7 and dt.max() <= 1e-1 + 1e-7
    for k in ("conv_w", "in_proj", "dt_proj"):
        key = f"stack/g0/p0/mixer/{k}"
        assert abs(got[key].std() / want[key].std() - 1) < 0.1, k


# --------------------------------------------------------------------- model
def test_forward_matches_jax(model):
    cfg, params, tcfg, tparams, _ = model
    tokens = np.random.RandomState(4).randint(0, cfg.vocab_size, (2, 23)).astype(np.int32)
    want, waux = compiled(lambda p, t: jforward(cfg, p, {"tokens": t}, RT), params,
                          jnp.asarray(tokens))(params, jnp.asarray(tokens))
    got, aux = tforward(tcfg, tparams, {"tokens": torch.from_numpy(tokens)}, TRT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODEL_TOL, rtol=MODEL_TOL)
    assert float(aux) == float(waux) == 0.0


@pytest.mark.parametrize("fused", [False, True], ids=["dense-head", "chunked-ce"])
def test_loss_fn_matches_jax(model, fused):
    cfg, params, tcfg, tparams, _ = model
    rng = np.random.RandomState(5)
    tokens = rng.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    labels[0, :4] = -1
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    want, _ = compiled(lambda p, b: jloss_fn(cfg, p, b, RT), params, batch)(params, batch)
    got, parts = tloss_fn(tcfg, tparams, {"tokens": torch.from_numpy(tokens),
                                          "labels": torch.from_numpy(labels)},
                          TRT.replace(fused_backward=fused, ce_chunk=256))
    assert abs(float(got) - float(want)) < 1e-5 * abs(float(want))
    assert float(parts["aux"]) == 0.0


@pytest.mark.parametrize("S", [2, 13])
def test_prefill_then_decode_matches_jax(model, S):
    """prefill's logits and every layer's collected {conv, ssm}, then four
    decode steps' logits and states (the dense serving path)."""
    cfg, params, tcfg, tparams, _ = model
    tokens = np.random.RandomState(6).randint(0, cfg.vocab_size, (2, S)).astype(np.int32)
    horizon = S + 4
    wl, wst = compiled(lambda p, t: jprefill(cfg, p, {"tokens": t}, RT, max_len=horizon,
                                             full_cache=True),
                       params, jnp.asarray(tokens))(params, jnp.asarray(tokens))
    gl, gst = tprefill(tcfg, tparams, {"tokens": torch.from_numpy(tokens)}, TRT,
                       max_len=horizon, full_cache=True)
    specs = jlayer_specs(cfg, seq_len=S)

    def check(got_logits, want_logits, got_state, want_state, what):
        np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                                   atol=MODEL_TOL, rtol=MODEL_TOL, err_msg=what)
        want = jax_layers(want_state["caches"], cfg, specs)
        assert len(got_state["caches"]) == len(want) == tcfg.n_layers
        for i, (g, w) in enumerate(zip(got_state["caches"], want)):
            assert set(g) == set(w) == {"conv", "ssm"}
            for k in ("conv", "ssm"):
                np.testing.assert_allclose(g[k].numpy(), w[k], atol=MODEL_TOL, rtol=MODEL_TOL,
                                           err_msg=f"{what} layer {i} {k}")
        assert got_state["t"] == int(want_state["t"])

    check(gl, wl, gst, wst, "prefill")
    step = compiled(lambda p, s, t: jdecode_step(cfg, p, s, t, RT, horizon), params, wst,
                    jnp.zeros(2, jnp.int32))
    tok = np.asarray(wl).argmax(-1).astype(np.int32)
    for i in range(4):
        wl, wst = step(params, wst, jnp.asarray(tok))
        gl = tdecode_step(tcfg, tparams, gst, torch.from_numpy(tok), TRT, horizon)
        check(gl, wl, gst, wst, f"step {i}")
        tok = np.asarray(wl).argmax(-1).astype(np.int32)


def test_init_decode_state_matches_jax_layout(model):
    _, _, tcfg, tparams, _ = model
    st = init_decode_state(tcfg, tparams, 3, 40, TRuntime(dtype=torch.bfloat16))
    assert st["t"] == 39 and len(st["caches"]) == tcfg.n_layers
    for c in st["caches"]:
        assert c["conv"].shape == (3, 3, tcfg.d_inner) and c["conv"].dtype == torch.bfloat16
        assert c["ssm"].shape == (3, tcfg.d_inner, 16) and c["ssm"].dtype == torch.float32


# ------------------------------------------------------------------- serving
def prompts_of(cfg):
    rng = np.random.RandomState(7)
    return [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32) for n in LENGTHS]


@pytest.fixture(scope="module")
def jax_engine(model):
    """JAX's dense-fallback engine over LENGTHS (paged=None picks it): its
    tokens and stats."""
    cfg, params, _, _, _ = model
    prompts = prompts_of(cfg)
    je = JServeEngine(cfg, params, RT, JEngineConfig(max_slots=2))
    assert not je.paged
    rids = [je.submit(p, NEW) for p in prompts]
    out = je.run()
    return prompts, [np.asarray(out[r]) for r in rids], je.stats, rids


def test_generate_matches_jax(model, jax_engine):
    """train.serve.generate over the two 9-token prompts: greedy tokens
    identical to JAX's generate, and to JAX's engine."""
    cfg, params, tcfg, tparams, _ = model
    prompts, engine_want, _, _ = jax_engine
    batch = np.stack([prompts[0], prompts[2]])
    want, _ = jgenerate(cfg, params, {"tokens": jnp.asarray(batch)}, RT, NEW)
    got, state = generate(tcfg, tparams, {"tokens": batch}, TRT, NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[1].numpy(), engine_want[2])
    assert state["t"] == len(prompts[0]) + NEW - 1


@pytest.mark.parametrize("layers", [2, 16])
def test_bf16_decode_parts_from_forward_as_jax_does(layers):
    """In bf16 the recurrent decode and the full-sequence scan round in
    different places, and their logits part further with depth, in JAX as
    in the port (a 64-layer card run parts by over 4% of max|logit|; PERF.md
    §6). On JAX's weights and JAX's greedy tokens, the port's dense decode
    logits part from the port's teacher-forced forward by at most 1.5x the
    share by which JAX's part from JAX's (``-s`` prints both)."""
    B, S, new = 2, 64, 8
    cfg = dataclasses.replace(get_reduced(ARCH), n_layers=layers)
    tcfg = dataclasses.replace(t_get_reduced(ARCH), n_layers=layers)
    key = jax.random.PRNGKey(0)
    params = compiled(lambda k: init_params(cfg, k), key)(key)
    rt, trt = Runtime(dtype=jnp.bfloat16), TRuntime(dtype=torch.bfloat16)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu",
                              dtype=torch.bfloat16)
    V, horizon = cfg.vocab_size, S + new
    prompt = np.random.RandomState(7).randint(0, V, (B, S)).astype(np.int32)
    logits, state = compiled(lambda p, t: jprefill(cfg, p, {"tokens": t}, rt, max_len=horizon),
                             params, prompt)(params, prompt)
    step = compiled(lambda p, s, t: jdecode_step(cfg, p, s, t, rt, horizon), params, state,
                    jnp.zeros(B, jnp.int32))
    want = [np.asarray(logits[:, :V], np.float32)]
    for _ in range(1, new):
        logits, state = step(params, state, jnp.asarray(want[-1].argmax(-1), jnp.int32))
        want.append(np.asarray(logits[:, :V], np.float32))
    want = np.stack(want, 1)
    toks = want.argmax(-1).astype(np.int32)
    seq = np.concatenate([prompt, toks[:, :-1]], 1)
    ref = compiled(lambda p, t: jforward(cfg, p, {"tokens": t}, rt)[0], params, seq)(params, seq)
    ref = np.asarray(ref, np.float32)[:, S - 1:, :V]
    with torch.no_grad():
        tl, tst = tprefill(tcfg, tparams, {"tokens": torch.from_numpy(prompt)}, trt,
                           max_len=horizon)
        got = [tl[:, :V].float()]
        for i in range(1, new):
            got.append(tdecode_step(tcfg, tparams, tst, torch.from_numpy(toks[:, i - 1]), trt,
                                    horizon)[:, :V].float())
        got = torch.stack(got, 1).numpy()
        tref = tforward(tcfg, tparams, {"tokens": torch.from_numpy(seq)}, trt)[0]
        tref = tref[:, S - 1:, :V].float().numpy()

    def parted(a, b):
        return float((np.abs(a - b).max(-1) / np.abs(b).max(-1)).max())

    jax_share, port_share = parted(want, ref), parted(got, tref)
    print(f"bf16 decode vs forward, {layers} layers: JAX {jax_share}, port {port_share}")
    assert np.isfinite(got).all() and port_share <= 1.5 * jax_share


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_dense_engine_matches_jax(model, jax_engine, kv_dtype):
    """ServeEngine with paged=None serves the SSM dense: tokens identical to
    JAX's dense-fallback engine, JAX's kv_bytes (its recurrent share), and a
    kv_dtype changes nothing (JAX's test_quantized_kv_dtype_noop_on_dense_fallback)."""
    cfg, _, tcfg, tparams, _ = model
    prompts, want, jstats, jrids = jax_engine
    eng = ServeEngine(tcfg, tparams, TRT, EngineConfig(max_slots=2, kv_dtype=kv_dtype),
                      device="cpu")
    assert not eng.paged and eng.kv_pool_bytes_per_device() == 0
    rids = [eng.submit(p, NEW) for p in prompts]
    first = eng.step()
    assert first["finished"] == [rids[0], rids[2]]     # one (length, max_new) batch
    while eng.busy:
        eng.step()
    out = eng.run_finalize()
    for r, jr, w in zip(rids, jrids, want):
        np.testing.assert_array_equal(out[r], w, err_msg=f"request {r}")
        assert eng.stats["kv_bytes"][r] == jstats["kv_bytes"][jr] > 0
    assert eng.stats["kv_bytes"][rids[0]] == jdense_kv_bytes(cfg, RT, len(prompts[0]) + NEW)


def test_paged_serving_refuses_the_ssm(model):
    """The family's decode state is no KV cache: paged=True raises JAX's
    ValueError, as do generate(paged=True) and pricing a pool for it; the
    paged pool itself refuses its layers."""
    _, _, tcfg, tparams, _ = model
    with pytest.raises(ValueError, match="non-KV decode state"):
        ServeEngine(tcfg, tparams, TRT, EngineConfig(), paged=True, device="cpu")
    with pytest.raises(ValueError, match="non-KV decode state"):
        generate(tcfg, tparams, {"tokens": np.zeros((1, 4), np.int32)}, TRT, 2, paged=True)
    with pytest.raises(ValueError, match="no KV pool"):
        EngineConfig.capacity(64, 8, pool_bytes=1 << 20, cfg=tcfg)
    with pytest.raises(NotImplementedError, match="attention mixers only"):
        init_stack_pool(tcfg, TRT, layer_specs(tcfg, seq_len=16), 4, 8, device="cpu")


def test_ssm_pipeline_stage_raises_naming_item_7(model):
    _, _, tcfg, _, _ = model
    with pytest.raises(NotImplementedError, match="item 7"):
        pipeline_fns(tcfg, TRT)


def test_chunked_scan_refuses_a_partial_chunk(mixers):
    """The chunked scan takes whole chunks only, as JAX's asserts."""
    _, tps = mixers
    tx = torch.zeros(1, 37, tps[torch.float32].in_proj.shape[0])
    with pytest.raises(AssertionError):
        tssm.mamba_apply(tps[torch.float32], tx, scan_mode="chunked", chunk=16)


@pytest.mark.parametrize("argv,expect", [
    ([], "dense: 8 tokens"),
    (["--paged", "--requests", "3"], "dense state: bytes/request="),
])
def test_launcher_serves_the_ssm_dense_on_cpu(argv, expect, capsys):
    launch_serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2", "--new-tokens", "4",
                       "--prompt-len", "8", "--temperature", "0"] + argv)
    out = capsys.readouterr().out
    assert "falcon-mamba-7b-reduced" in out and expect in out, out
