"""The port's encoder-decoder (seamless-m4t-medium) against the JAX package,
on the CPU, at reduced size (2 encoder and 2 decoder layers, d 256, 4
heads of hd 64, LayerNorm, 16 audio frames, vocabulary 1,024).

* The converter carries the enc-dec tree (``enc_stack``, ``enc_norm``, each
  decoder block's ``norm_x`` and ``cross``, the LayerNorm biases) across
  and back bitwise, nested and flat; ``init_params`` draws the same tree.
* The pieces, in f32 (within 1e-5 of max|ref|) and bf16 (``BF16_TOL`` of
  max|ref|): ``encode``, ``attention_apply(memory=)`` (the plain K1 at Sq !=
  Sk, not causal, no RoPE) against JAX's plain cross path, and
  ``cross_decode`` against JAX's ``_cross_decode``.
* The model: ``forward`` (f32 and bf16), ``loss_fn`` (dense and chunked-CE
  heads), ``prefill``'s memory, cross caches and rings, then four
  ``decode_step`` logits; ``init_decode_state`` sizes the cross caches by
  ``frontend_tokens``.
* Serving: greedy ``train.serve.generate`` and the dense engine (three
  requests, each with its own frames) equal to JAX's, with JAX's
  ``kv_bytes`` and batched == alone; ``paged=True`` raises; a submit
  without its frames or with frames of another shape raises before any
  state changes; the frames reach the tokens.
* seamless's decoder alone (``enc_layers=0``): JAX drops its frames and
  serves it paged; the port's engine gives JAX's tokens.
* The launcher serves seamless on the CPU, dense.

The JAX side compiles each program once (module fixtures; XLA's backend
optimisation off and no excess precision, as ``test_torch_ssm.compiled``).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _flatten
from repro.configs import get_reduced
from repro.models import Runtime, init_params
from repro.models import attention as jattn
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_decode_state as jinit_decode_state
from repro.models import loss_fn as jloss_fn
from repro.models import prefill as jprefill
from repro.models.lm import encode as jencode
from repro.models.stack import _cross_decode as jcross_decode
from repro.models.stack import layer_specs as jlayer_specs
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve.engine import dense_kv_bytes as jdense_kv_bytes
from repro.train.serve import generate as jgenerate
from repro_torch.checkpoint import params_from_jax, params_to_numpy
from repro_torch.checkpoint.convert import leaf_groups
from repro_torch.configs import get_reduced as t_get_reduced
from repro_torch.launch import serve as launch_serve
from repro_torch.models import Runtime as TRuntime
from repro_torch.models import decode_step as tdecode_step
from repro_torch.models import encode as tencode
from repro_torch.models import forward as tforward
from repro_torch.models import init_decode_state, pipeline_fns
from repro_torch.models import init_params as tinit_params
from repro_torch.models import loss_fn as tloss_fn
from repro_torch.models import prefill as tprefill
from repro_torch.models.attention import attention_apply, cross_decode
from repro_torch.serve import EngineConfig, ServeEngine
from repro_torch.train.serve import generate
from test_torch_serve_whole import jax_layers
from test_torch_ssm import compiled

# pytest-xdist runs several workers on one machine: give torch this worker's share
# of the cores (oversubscribed, the torch side runs many times slower)
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

ARCH = "seamless-m4t-medium"
RT = Runtime(dtype=jnp.float32)
TRT = TRuntime(dtype=torch.float32)
TOL = 1e-5                       # of max|ref|: f32 on both sides, sums in another order
MODEL_TOL = 2e-5                 # the model's logits and caches, f32
# bf16, of max|ref|: the port's cross and self attention keep p in f32 up to
# the one rounding of o (K1's plain version), where JAX's plain path rounds
# the softmax to bf16 before the combine; a few such roundings through the
# layers
BF16_TOL = 2e-2
LENGTHS = (9, 5, 9)              # requests 0 and 2 batch in the dense engine
NEW = 6
DTYPES = [torch.float32, torch.bfloat16]
DT_IDS = ["f32", "bf16"]


@pytest.fixture(scope="module")
def model():
    cfg, tcfg = get_reduced(ARCH), t_get_reduced(ARCH)
    key = jax.random.PRNGKey(0)
    params = compiled(lambda k: init_params(cfg, k), key)(key)
    tree = jax.tree.map(np.asarray, params)
    return cfg, params, tcfg, params_from_jax(tree, tcfg, device="cpu"), tree


def jdt(dtype):
    return jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32


def rt_of(dtype):
    return Runtime(dtype=jdt(dtype)), TRuntime(dtype=dtype)


def port_params(model, dtype):
    _, _, tcfg, tparams, tree = model
    return tparams if dtype == torch.float32 else params_from_jax(
        tree, tcfg, device="cpu", dtype=dtype)


def frames(cfg, seed, B=None):
    shape = (cfg.frontend_tokens, cfg.d_model) if B is None else (
        B, cfg.frontend_tokens, cfg.d_model)
    return np.random.RandomState(100 + seed).randn(*shape).astype(np.float32)


def tokens(cfg, B, S, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, S)).astype(np.int32)


def jbatch(tok, fr):
    return {"tokens": jnp.asarray(tok), "frontend_embeds": jnp.asarray(fr)}


def tbatch(tok, fr):
    return {"tokens": torch.from_numpy(tok), "frontend_embeds": torch.from_numpy(fr)}


def assert_close(got, want, dtype, what, tol=None):
    """Within ``tol`` (default TOL in f32, BF16_TOL in bf16) of max|want|."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = tol or (TOL if dtype == torch.float32 else BF16_TOL)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
    assert err <= tol, (what, err, tol)


# ----------------------------------------------------------------- converter
@pytest.mark.parametrize("flat", [False, True], ids=["nested", "flat"])
def test_params_from_jax_round_trips_the_encdec_tree(model, flat):
    """Every leaf of JAX's enc-dec tree (the decoder's cross blocks, the
    encoder's stack and norm, the LayerNorm biases) comes back bitwise, with
    JAX's keys and shapes, and ``leaf_groups`` lists JAX's leaves."""
    _, params, tcfg, _, tree = model
    want = _flatten(params)
    assert {"enc_norm/bias", "enc_stack/g0/p0/mixer/wq", "stack/g0/p0/cross/wv",
            "stack/g0/p0/norm_x/bias"} <= set(want)
    a = params_from_jax(want if flat else tree, tcfg, device="cpu")
    got = _flatten(params_to_numpy(a))
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert {lf.key: lf.shape for lf in leaf_groups(a)} == {k: v.shape for k, v in want.items()}
    assert len(a.enc_stack.layers) == tcfg.enc_layers and len(a.stack.layers) == tcfg.n_layers
    assert all(bp.cross is None for bp in a.enc_stack.layers)
    assert all(bp.cross is not None for bp in a.stack.layers)


def test_init_params_draws_jax_tree(model):
    """``init_params`` gives JAX's keys and shapes; LayerNorm scales 1 and
    biases 0; the cross and encoder matrices JAX's fan-in spread."""
    _, params, tcfg, _, _ = model
    want = _flatten(params)
    got = _flatten(params_to_numpy(tinit_params(tcfg, seed=0, device="cpu",
                                                dtype=torch.float32)))
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    for k in ("enc_norm", "stack/g0/p0/norm_x", "enc_stack/g0/p0/norm1"):
        assert (got[f"{k}/scale"] == 1).all() and not got[f"{k}/bias"].any(), k
    for k in ("stack/g0/p0/cross/wq", "enc_stack/g0/p0/mixer/wk", "enc_stack/g0/p0/ffn/w_up"):
        assert abs(got[k].std() / want[k].std() - 1) < 0.1, k


# -------------------------------------------------------------------- pieces
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_encode_matches_jax(model, dtype):
    """The bidirectional encoder and ``enc_norm`` over 2 x 16 frames."""
    cfg, params, tcfg, _, _ = model
    rt, trt = rt_of(dtype)
    fr = frames(cfg, 0, B=2)
    want = compiled(lambda p, f: jencode(cfg, p, f, rt), params, fr)(params, fr)
    got = tencode(tcfg, port_params(model, dtype), torch.from_numpy(fr), trt)
    assert got.dtype == dtype
    assert_close(got, want, dtype, "memory")


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_cross_attention_apply_matches_jax(model, dtype):
    """Layer 0's cross-attention: 11 query rows from x against the 16 rows
    of memory (Sq != Sk, not causal, no RoPE); the collected k/v are JAX's
    ``memory @ wk``, ``memory @ wv``."""
    cfg, params, tcfg, _, tree = model
    cross = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["stack"]["g0"]["p0"]["cross"])
    tp = port_params(model, dtype).stack.layers[0].cross
    x = np.random.RandomState(1).randn(2, 11, cfg.d_model).astype(np.float32)
    mem = frames(cfg, 1, B=2)
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
              theta=cfg.rope_theta)
    jx, jm = (jnp.asarray(a).astype(jdt(dtype)) for a in (x, mem))
    want, _ = compiled(lambda p, a, m: jattn.attention_apply(
        p, a, window=0, causal=False, memory=m, **kw), cross, jx, jm)(cross, jx, jm)
    tx, tm = (torch.from_numpy(a).to(dtype) for a in (x, mem))
    got, kv = attention_apply(tp, tx, memory=tm, collect_kv=True, **kw)
    assert_close(got, want, dtype, "cross out")
    for name, w in (("k", "wk"), ("v", "wv")):
        ref = (jm @ cross[w].astype(jdt(dtype))).reshape(2, 16, cfg.n_kv_heads, cfg.head_dim)
        assert_close(kv[name], ref, dtype, name, tol=TOL)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_cross_decode_matches_jax(model, dtype):
    """One decode token against cached encoder k/v: f32 scores, the softmax
    cast to the dtype, then the combine, as JAX's ``_cross_decode``."""
    cfg, _, tcfg, _, tree = model
    cross = jax.tree.map(lambda a: jnp.asarray(a[1]), tree["stack"]["g0"]["p0"]["cross"])
    tp = port_params(model, dtype).stack.layers[1].cross
    rng = np.random.RandomState(2)
    x = rng.randn(3, 1, cfg.d_model).astype(np.float32)
    ck, cv = (rng.randn(3, 16, cfg.n_kv_heads, cfg.head_dim).astype(np.float32)
              for _ in range(2))
    j = [jnp.asarray(a).astype(jdt(dtype)) for a in (x, ck, cv)]
    want, _ = compiled(lambda p, *a: jcross_decode(cfg, p, *a), cross, *j)(cross, *j)
    t = [torch.from_numpy(a).to(dtype) for a in (x, ck, cv)]
    got = cross_decode(tp, *t, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                       head_dim=cfg.head_dim)
    # one decode step's single rounding: a bf16 ulp of the output
    assert_close(got, want, dtype, "cross decode", tol=TOL if dtype == torch.float32 else 1e-2)


# --------------------------------------------------------------------- model
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_forward_matches_jax(model, dtype):
    """Logits over 2 x 11 text tokens, each row behind its own frames."""
    cfg, params, tcfg, _, _ = model
    rt, trt = rt_of(dtype)
    tok, fr = tokens(cfg, 2, 11, 3), frames(cfg, 3, B=2)
    want, _ = compiled(lambda p, b: jforward(cfg, p, b, rt), params, jbatch(tok, fr))(
        params, jbatch(tok, fr))
    got, aux = tforward(tcfg, port_params(model, dtype), tbatch(tok, fr), trt)
    assert got.shape == (2, 11, tcfg.vocab_padded) and float(aux) == 0.0
    assert_close(got, want, dtype, "logits", tol=MODEL_TOL if dtype == torch.float32 else None)


@pytest.mark.parametrize("fused", [False, True], ids=["dense-head", "chunked-ce"])
def test_loss_matches_jax(model, fused):
    """loss_fn over the text rows (some labels -1): total, xent and z-loss
    against JAX's (1e-5), f32."""
    cfg, params, tcfg, tparams, _ = model
    tok, fr = tokens(cfg, 2, 12, 4), frames(cfg, 4, B=2)
    labels = tokens(cfg, 2, 12, 5)
    labels[0, :3] = -1
    jb = dict(jbatch(tok, fr), labels=jnp.asarray(labels))
    tb = dict(tbatch(tok, fr), labels=torch.from_numpy(labels))
    rt = RT.replace(fused_backward=fused, ce_chunk=256)
    _, want = compiled(lambda p, b: jloss_fn(cfg, p, b, rt), params, jb)(params, jb)
    _, got = tloss_fn(tcfg, tparams, tb, TRT.replace(fused_backward=fused, ce_chunk=256))
    for k in ("loss", "xent", "z_loss"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_prefill_caches_and_decode_match_jax(model, dtype):
    """prefill over 2 x 9 tokens behind their frames: the logits, the
    memory, each layer's cross caches (JAX's collected ``ck``/``cv``) and
    ring; then four decode steps fed JAX's greedy tokens, their logits."""
    cfg, params, tcfg, _, _ = model
    rt, trt = rt_of(dtype)
    S, new = 9, 4
    tok, fr = tokens(cfg, 2, S, 6), frames(cfg, 6, B=2)
    horizon = S + new
    jl, js = compiled(lambda p, b: jprefill(cfg, p, b, rt, max_len=horizon), params,
                      jbatch(tok, fr))(params, jbatch(tok, fr))
    tp = port_params(model, dtype)
    tl, ts = tprefill(tcfg, tp, tbatch(tok, fr), trt, max_len=horizon)
    tol = MODEL_TOL if dtype == torch.float32 else None
    assert_close(tl, jl, dtype, "prefill logits", tol)
    assert_close(ts["memory"], js["memory"], dtype, "memory", tol)
    assert ts["t"] == int(js["t"]) == S
    cross = js["caches"][0]["p0"]
    rings = jax_layers([{"p0": c["p0"]["self"]} for c in js["caches"]], cfg,
                       jlayer_specs(cfg, seq_len=horizon))
    assert len(ts["caches"]) == tcfg.n_layers
    for i, c in enumerate(ts["caches"]):
        assert set(c) == {"self", "ck", "cv"}
        for k in ("ck", "cv"):
            assert_close(c[k], cross[k][i], dtype, f"layer {i} {k}", tol)
        np.testing.assert_array_equal(c["self"]["pos"].numpy(), rings[i]["pos"])
        for k in "kv":
            assert_close(c["self"][k], rings[i][k], dtype, f"layer {i} ring {k}", tol)
    step = compiled(lambda p, s, t: jdecode_step(cfg, p, s, t, rt, horizon), params, js,
                    jnp.zeros(2, jnp.int32))
    for i in range(new):
        t = jnp.argmax(jl[:, :cfg.vocab_size], -1).astype(jnp.int32)
        jl, js = step(params, js, t)
        tl = tdecode_step(tcfg, tp, ts, torch.from_numpy(np.array(t)), trt, horizon)
        assert_close(tl, jl, dtype, f"decode step {i}", tol)
    assert ts["t"] == S + new


def test_init_decode_state_sizes_the_cross_caches(model):
    """The zero state: each layer's ring and cross caches of
    frontend_tokens rows, and a zero memory, JAX's shapes."""
    cfg, params, tcfg, tparams, _ = model
    want = jinit_decode_state(cfg, params, 3, 20, Runtime(dtype=jnp.bfloat16))
    got = init_decode_state(tcfg, tparams, 3, 20, TRuntime(dtype=torch.bfloat16))
    assert tuple(got["memory"].shape) == want["memory"].shape == (3, 16, cfg.d_model)
    assert got["t"] == int(want["t"]) == 19
    jc = want["caches"][0]["p0"]
    for c in got["caches"]:
        for k in ("ck", "cv"):
            assert tuple(c[k].shape) == jc[k].shape[1:] and c[k].dtype == torch.bfloat16
            assert not c[k].any()
        assert tuple(c["self"]["k"].shape) == jc["self"]["k"].shape[1:]


# ------------------------------------------------------------------- serving
def requests(cfg):
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32) for n in LENGTHS]
    return prompts, [frames(cfg, 10 + i) for i in range(len(prompts))]


@pytest.fixture(scope="module")
def jax_engine(model):
    """JAX's engine (dense, as JAX serves an encoder-decoder) over the three
    requests, each behind its frames: tokens, stats, rids."""
    cfg, params, _, _, _ = model
    prompts, fes = requests(cfg)
    je = JServeEngine(cfg, params, RT, JEngineConfig(max_slots=2))
    assert not je.paged
    rids = [je.submit(p, NEW, frontend_embeds=fe) for p, fe in zip(prompts, fes)]
    out = je.run()
    return prompts, fes, [np.asarray(out[r]) for r in rids], je.stats, rids


def test_generate_matches_jax(model, jax_engine):
    """Greedy train.serve.generate over requests 0 and 2 (one length), each
    behind its frames: JAX's generate's tokens."""
    cfg, params, tcfg, tparams, _ = model
    prompts, fes, _, _, _ = jax_engine
    batch = {"tokens": np.stack([prompts[0], prompts[2]]),
             "frontend_embeds": np.stack([fes[0], fes[2]])}
    want, _ = jgenerate(cfg, params, jax.tree.map(jnp.asarray, batch), RT, NEW)
    got, state = generate(tcfg, tparams, batch, TRT, NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert state["t"] == LENGTHS[0] + NEW - 1 and "memory" in state


def test_dense_engine_matches_jax(model, jax_engine):
    """ServeEngine (paged=None: dense) serves the three requests with their
    frames: JAX's tokens and kv_bytes (no cross-cache share, as JAX bills
    none), requests 0 and 2 in one batch, each equal to its run alone."""
    cfg, _, tcfg, tparams, _ = model
    prompts, fes, want, jstats, jrids = jax_engine
    eng = ServeEngine(tcfg, tparams, TRT, EngineConfig(max_slots=2), device="cpu")
    assert not eng.paged and eng.kv_pool_bytes_per_device() == 0
    rids = [eng.submit(p, NEW, frontend_embeds=fe) for p, fe in zip(prompts, fes)]
    assert eng.step()["finished"] == [rids[0], rids[2]]
    while eng.busy:
        eng.step()
    out = eng.run_finalize()
    for r, jr, w in zip(rids, jrids, want):
        np.testing.assert_array_equal(out[r], w, err_msg=f"request {r}")
        assert eng.stats["kv_bytes"][r] == jstats["kv_bytes"][jr] > 0
    assert eng.stats["kv_bytes"][rids[1]] == jdense_kv_bytes(cfg, RT, LENGTHS[1] + NEW)
    for i in (0, 2):
        alone = ServeEngine(tcfg, tparams, TRT, EngineConfig(max_slots=1), device="cpu")
        a = alone.submit(prompts[i], NEW, frontend_embeds=fes[i])
        np.testing.assert_array_equal(alone.run()[a], out[rids[i]], err_msg=f"request {i}")


def test_the_frames_reach_the_tokens(model, jax_engine):
    """The same prompt behind other frames: another first-token logit row."""
    cfg, _, tcfg, tparams, _ = model
    prompts, fes, _, _, _ = jax_engine
    batch = tbatch(np.stack([prompts[0]] * 2), np.stack([fes[0], frames(cfg, 50)]))
    logits, _ = tprefill(tcfg, tparams, batch, TRT)
    assert float((logits[0] - logits[1]).abs().max()) > 0.1 * float(logits[0].abs().max())


def test_paged_serving_refuses_the_encdec(model):
    """No pool holds the cross caches: paged=True raises JAX's ValueError,
    as do generate(paged=True) and pricing a pool; its pipeline stage
    raises as JAX's does."""
    _, _, tcfg, tparams, _ = model
    with pytest.raises(ValueError, match="non-KV decode state"):
        ServeEngine(tcfg, tparams, TRT, EngineConfig(), paged=True, device="cpu")
    batch = {"tokens": np.zeros((1, 4), np.int32), "frontend_embeds": frames(tcfg, 0, B=1)}
    with pytest.raises(ValueError, match="non-KV decode state"):
        generate(tcfg, tparams, batch, TRT, 2, paged=True)
    with pytest.raises(ValueError, match="no KV pool"):
        EngineConfig.capacity(64, 8, pool_bytes=1 << 20, cfg=tcfg)
    with pytest.raises(ValueError, match="encoder-decoder"):
        pipeline_fns(tcfg, TRT)


@pytest.mark.parametrize("fe", ["none", "short", "wide"])
def test_submit_needs_its_frames(model, fe):
    """A submit without frames, or with frames of another shape, raises
    ValueError before any state changes."""
    _, _, tcfg, tparams, _ = model
    eng = ServeEngine(tcfg, tparams, TRT, EngineConfig(max_slots=2), device="cpu")
    T, d = tcfg.frontend_tokens, tcfg.d_model
    given = {"none": None, "short": np.zeros((T - 1, d), np.float32),
             "wide": np.zeros((T, d + 1), np.float32)}[fe]
    with pytest.raises(ValueError, match="frontend_embeds"):
        eng.submit(np.arange(5, dtype=np.int32), 3, frontend_embeds=given)
    assert eng._next_rid == 0 and not eng.busy


# ------------------------------------------------------------ decoder alone
def test_decoder_alone_serves_as_jax_does():
    """seamless with ``enc_layers=0``: no encoder, so JAX drops the frames
    (``_decoder_input``) and serves it paged (``paged_supported``); the
    port's engine, given the same frames, gives JAX's tokens, and its
    forward ignores them."""
    over = dict(enc_layers=0)
    cfg = dataclasses.replace(get_reduced(ARCH), **over)
    tcfg = dataclasses.replace(t_get_reduced(ARCH), **over)
    key = jax.random.PRNGKey(1)
    params = compiled(lambda k: init_params(cfg, k), key)(key)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    assert tparams.enc_stack is None and tparams.stack.layers[0].cross is None
    prompts, fes = requests(cfg)
    ecfg = dict(max_slots=2, page_size=8, num_pages=17, max_len=32, prefill_bucket=16)
    je = JServeEngine(cfg, params, RT, JEngineConfig(**ecfg))
    te = ServeEngine(tcfg, tparams, TRT, EngineConfig(**ecfg), device="cpu")
    assert je.paged and te.paged
    jr = [je.submit(p, NEW, frontend_embeds=fe) for p, fe in zip(prompts, fes)]
    tr = [te.submit(p, NEW, frontend_embeds=fe) for p, fe in zip(prompts, fes)]
    jo, to = je.run(), te.run()
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(to[b], np.asarray(jo[a]))
    tok = np.stack([prompts[0]])
    with_fr, _ = tforward(tcfg, tparams, tbatch(tok, fes[0][None]), TRT)
    without, _ = tforward(tcfg, tparams, {"tokens": torch.from_numpy(tok)}, TRT)
    assert torch.equal(with_fr, without)


# ------------------------------------------------------------------ launcher
@pytest.mark.parametrize("argv,expect", [
    ([], "dense: 8 tokens"),
    (["--paged", "--requests", "3"], "dense state: bytes/request="),
])
def test_launcher_serves_seamless_on_cpu(argv, expect, capsys):
    launch_serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2", "--new-tokens", "4",
                       "--prompt-len", "8", "--temperature", "0"] + argv)
    out = capsys.readouterr().out
    assert "seamless-m4t-medium-reduced" in out and expect in out, out
