"""The port's RG-LRU hybrid (recurrentgemma-2b: a unit of rglru, rglru,
local attention) against the JAX package, on the CPU, at reduced size with
8 layers (d 256, RG-LRU width 256 in 8 blocks, 4 query heads over 1 kv head
of hd 64, window 64, conv 4, vocabulary 1,024): JAX stores it as two
parameter groups, ``g0`` (the unit, 2 repeats) and ``g1`` (the tail of 2
rglru layers), so layers 6 and 7 read ``g1``.

* The block (layer 0's mixer, carried across by ``params_from_jax``):
  ``gelu_tanh`` against ``jax.nn.gelu``; ``rglru_apply`` and its collected
  ``{conv, h}`` at S 1, 2 (under K - 1: the conv state is left-padded), 3,
  37 and 64; a prefill then a chain of ``rglru_decode`` steps. f32 within
  1e-5 of max|ref|; bf16 within one bf16 ulp in at least 99% of the
  elements, against JAX compiled without excess precision (each bf16 step
  rounded, as the program says).
* The converter round-trips JAX's patterned tree bitwise at 3, 5 and 8
  layers (no tail, a tail of 2, repeats and a tail), nested and flat, and
  ``leaf_groups`` lists JAX's leaves; the full config's layer 24 and 25
  read ``g1``.
* The model in f32: ``forward``'s logits and ``loss_fn`` (dense and
  chunked-CE heads); ``prefill`` then four ``decode_step``s, logits and
  every layer's ring or ``{conv, h}`` state, over prompts of 40 (with
  full-horizon caches), 2 and 64 tokens.
* Serving: ``ServeEngine`` (``paged=None``: the dense path) gives JAX's
  dense engine's greedy tokens and ``kv_bytes``, batched == alone; a
  70-token prompt (past the 64 window, where JAX's ring is not exact) is
  held to the port's own teacher-forced argmax; ``paged=True`` raises
  ``ValueError``; the pipeline refuses patterned storage; the
  sequence-parallel scan names item 6; the launcher serves it on the CPU.

The JAX side compiles each program once (module fixtures and one
``compiled`` per shape, XLA's backend optimisation off).
"""
import functools

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
from repro.models import rglru as jrglru
from repro.models.stack import layer_specs as jlayer_specs
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve.engine import dense_kv_bytes as jdense_kv_bytes
from repro_torch.checkpoint import params_from_jax, params_to_numpy
from repro_torch.checkpoint.convert import leaf_groups, unflatten
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import get_reduced as t_get_reduced
from repro_torch.launch import serve as launch_serve
from repro_torch.models import Runtime as TRuntime
from repro_torch.models import decode_step as tdecode_step
from repro_torch.models import forward as tforward
from repro_torch.models import init_decode_state, pipeline_fns
from repro_torch.models import init_params as tinit_params
from repro_torch.models import loss_fn as tloss_fn
from repro_torch.models import prefill as tprefill
from repro_torch.models import rglru as trglru
from repro_torch.models.stack import Slot, init_stack_pool, layer_specs, param_layout
from repro_torch.serve import EngineConfig, ServeEngine
from repro_torch.train.serve import generate
from test_torch_serve_whole import jax_layers, teacher_forced_argmax
from test_torch_ssm import DT_IDS, DTYPES, assert_agrees, compiled, inputs, jdt

ARCH = "recurrentgemma-2b"
LAYERS = 8                       # g0: (rglru, rglru, attn) x 2, g1: (rglru, rglru)
RT = Runtime(dtype=jnp.float32)
TRT = TRuntime(dtype=torch.float32)
MODEL_TOL = 2e-5                 # the model's logits and states, f32
LENGTHS = (20, 20, 20)           # one dense batch: JAX's engine compiles one shape
NEW = 6


@pytest.fixture(scope="module")
def model():
    cfg, tcfg = get_reduced(ARCH, n_layers=LAYERS), t_get_reduced(ARCH, n_layers=LAYERS)
    key = jax.random.PRNGKey(0)
    params = compiled(lambda k: init_params(cfg, k), key)(key)
    tree = jax.tree.map(np.asarray, params)
    return cfg, params, tcfg, params_from_jax(tree, tcfg, device="cpu"), tree


@pytest.fixture(scope="module")
def mixers(model):
    """Layer 0's mixer: the JAX leaves, and the port's at f32 and bf16."""
    _, _, tcfg, _, tree = model
    p = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["stack"]["g0"]["p0"]["mixer"])
    tp = {dt: params_from_jax(tree, tcfg, device="cpu", dtype=dt).stack.layers[0].mixer
          for dt in DTYPES}
    return p, tp


# --------------------------------------------------------------------- block
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_gelu_tanh_matches_jax(dtype):
    """``jax.nn.gelu``'s tanh approximation over [-8, 8] and a few large
    values: the constants at the dtype, each step rounded to it."""
    x = np.concatenate([np.linspace(-8, 8, 4001), [-40.0, -11.5, 9.25, 30.0]])
    x = x.astype(np.float32)[None]
    jx = jnp.asarray(x).astype(jdt(dtype))
    want = compiled(jax.nn.gelu, jx)(jx)
    assert_agrees(trglru.gelu_tanh(torch.from_numpy(x).to(dtype)), want, dtype, "gelu")


@pytest.mark.parametrize("S", [1, 2, 3, 37, 64])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_rglru_apply_and_state_match_jax(mixers, S, dtype):
    """The block's output and its collected state: the conv's last K - 1
    inputs (x @ w_in, left-padded under K - 1) and h after the last
    position."""
    p, tps = mixers
    d, w = p["w_in"].shape
    x, tx = inputs(S, d, dtype, seed=1)
    want, wst = compiled(functools.partial(jrglru.rglru_apply, collect_state=True),
                         p, x)(p, x)
    got, gst = trglru.rglru_apply(tps[dtype], tx, collect_state=True)
    assert got.dtype == dtype and gst["conv"].dtype == dtype
    assert gst["h"].dtype == torch.float32 and gst["conv"].shape == (2, 3, w)
    assert gst["conv"]._base is None and gst["h"]._base is None     # copies, not views
    assert_agrees(got, want, dtype, f"out S={S}")
    for k in ("conv", "h"):
        assert_agrees(gst[k], wst[k], dtype, f"{k} S={S}")
    if S < 3:
        assert not gst["conv"][:, : 3 - S].any()


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_rglru_decode_chain_matches_jax(mixers, dtype):
    """A 5-token prefix's collected state, then four recurrent steps: each
    step's output and the state it leaves."""
    p, tps = mixers
    tp = tps[dtype]
    d = p["w_in"].shape[0]
    x, tx = inputs(9, d, dtype, seed=2)
    _, wst = compiled(functools.partial(jrglru.rglru_apply, collect_state=True),
                      p, x[:, :5])(p, x[:, :5])
    _, gst = trglru.rglru_apply(tp, tx[:, :5], collect_state=True)
    jstep = compiled(jrglru.rglru_decode, p, x[:, 5:6], wst)
    for t in range(5, 9):
        want, wst = jstep(p, x[:, t: t + 1], wst)
        got, gst = trglru.rglru_decode(tp, tx[:, t: t + 1], gst)
        assert_agrees(got, want, dtype, f"out t={t}")
        for k in ("conv", "h"):
            assert_agrees(gst[k], wst[k], dtype, f"{k} t={t}")


def test_init_rglru_state_matches_jax(mixers):
    p, tps = mixers
    want = jrglru.init_rglru_state(p, 3, jnp.bfloat16)
    got = trglru.init_rglru_state(tps[torch.bfloat16], 3, torch.bfloat16)
    assert got["conv"].dtype == torch.bfloat16 and got["h"].dtype == torch.float32
    for k in ("conv", "h"):
        assert tuple(got[k].shape) == want[k].shape and not got[k].any()


def test_rglru_apply_seqpar_names_item_6(mixers):
    with pytest.raises(NotImplementedError, match="item 6"):
        trglru.rglru_apply_seqpar(mixers[1][torch.float32], torch.zeros(1, 4, 256))


# ----------------------------------------------------------------- converter
@pytest.mark.parametrize("layers", [3, 5, 8])
def test_params_from_jax_round_trips_patterned_storage(layers):
    """JAX's patterned tree (``g0`` the unit's repeats, ``g1`` the tail:
    its keys and shapes from ``jax.eval_shape`` of ``init_params``, random
    values) comes back bitwise with the same keys and shapes, nested and
    flat, and ``leaf_groups`` lists JAX's leaves with their stacked
    shapes."""
    cfg = get_reduced(ARCH, n_layers=layers)
    tcfg = t_get_reduced(ARCH, n_layers=layers)
    rng = np.random.RandomState(layers)
    flat = _flatten(jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                                 jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0)))))
    tree = unflatten(flat)
    groups = {k.split("/")[1] + "/" + k.split("/")[2] for k in flat if k.startswith("stack/")}
    tail = {"g1/p0", "g1/p1"} if layers % 3 else set()
    assert groups == {"g0/p0", "g0/p1", "g0/p2"} | tail
    a = params_from_jax(tree, tcfg, device="cpu")
    b = params_from_jax(flat, tcfg, device="cpu")
    for got in (params_to_numpy(a), params_to_numpy(b)):
        got = _flatten(got)
        assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in flat.items()}
        for k, v in flat.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert {lf.key: lf.shape for lf in leaf_groups(a)} == {k: v.shape for k, v in flat.items()}
    assert len(a.stack.layers) == layers
    assert [type(bp.mixer).__name__ for bp in a.stack.layers] == [
        "Attention" if k == "local" else "RGLRU" for k in tcfg.mixer_kinds()]


def test_full_config_layout_reads_the_tail_group():
    """recurrentgemma-2b's 26 layers: 8 units in g0, layers 24 and 25 in g1."""
    layout = param_layout(t_get_config(ARCH))
    assert len(layout) == 26
    assert layout[0] == Slot(0, 0, 0) and layout[5] == Slot(0, 2, 1)
    assert layout[23] == Slot(0, 2, 7)
    assert layout[24] == Slot(1, 0, 0) and layout[25] == Slot(1, 1, 0)


def test_params_from_jax_stores_rglru_leaves_by_role(model):
    """Matmuls, conv_w and the gate blocks at the compute dtype (JAX casts
    them at each use); conv_b, the gate biases and lam in f32."""
    _, _, tcfg, _, tree = model
    m = params_from_jax(tree, tcfg, device="cpu", dtype=torch.bfloat16).stack.layers[7].mixer
    for k in ("w_in", "w_gate", "conv_w", "gate_a", "gate_x", "w_out"):
        assert getattr(m, k).dtype == torch.bfloat16, k
    for k in ("conv_b", "bias_a", "bias_x", "lam"):
        assert getattr(m, k).dtype == torch.float32, k


def test_init_params_tree_and_distributions_match_jax(model):
    _, _, tcfg, _, tree = model
    want = _flatten(tree)
    got = _flatten(params_to_numpy(tinit_params(tcfg, seed=0, device="cpu",
                                                dtype=torch.float32)))
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    a = np.exp(-8.0 * np.log1p(np.exp(got["stack/g1/p1/mixer/lam"])))    # a at r = 1
    assert a.min() >= 0.9 - 1e-6 and a.max() <= 0.999 + 1e-6
    for k in ("gate_a", "conv_w", "w_in", "w_out"):
        key = f"stack/g0/p1/mixer/{k}"
        assert abs(got[key].std() / want[key].std() - 1) < 0.1, k
    for k in ("conv_b", "bias_a", "bias_x"):
        assert not got[f"stack/g0/p0/mixer/{k}"].any(), k


# --------------------------------------------------------------------- model
def test_forward_matches_jax(model):
    cfg, params, tcfg, tparams, _ = model
    tokens = np.random.RandomState(4).randint(0, cfg.vocab_size, (2, 23)).astype(np.int32)
    want, waux = compiled(lambda p, t: jforward(cfg, p, {"tokens": t}, RT), params,
                          jnp.asarray(tokens))(params, jnp.asarray(tokens))
    got, aux = tforward(tcfg, tparams, {"tokens": torch.from_numpy(tokens)}, TRT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODEL_TOL, rtol=MODEL_TOL)
    assert float(aux) == float(waux) == 0.0


@pytest.fixture(scope="module")
def loss_case(model):
    """A batch with masked labels and JAX's loss on it."""
    cfg, params, _, _, _ = model
    rng = np.random.RandomState(5)
    tokens = rng.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    labels[0, :4] = -1
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    want, _ = compiled(lambda p, b: jloss_fn(cfg, p, b, RT), params, batch)(params, batch)
    return tokens, labels, want


@pytest.mark.parametrize("fused", [False, True], ids=["dense-head", "chunked-ce"])
def test_loss_fn_matches_jax(model, loss_case, fused):
    _, _, tcfg, tparams, _ = model
    tokens, labels, want = loss_case
    got, parts = tloss_fn(tcfg, tparams, {"tokens": torch.from_numpy(tokens),
                                          "labels": torch.from_numpy(labels)},
                          TRT.replace(fused_backward=fused, ce_chunk=256))
    assert abs(float(got) - float(want)) < 1e-5 * abs(float(want))
    assert float(parts["aux"]) == 0.0


@pytest.mark.parametrize("S,full", [(40, True), (2, False), (64, False)])
def test_prefill_then_decode_matches_jax(model, S, full):
    """prefill's logits and every layer's collected state (the local
    layers' rings: k, v and positions; the RG-LRU layers' conv and h), then
    four decode steps' logits and states. With ``full_cache`` only the
    attention rings grow to the horizon; at 64 tokens the window's ring is
    full and the decode steps wrap it (a multiple of the window, where
    JAX's ring is exact)."""
    cfg, params, tcfg, tparams, _ = model
    tokens = np.random.RandomState(6).randint(0, cfg.vocab_size, (2, S)).astype(np.int32)
    horizon = S + 4
    wl, wst = compiled(lambda p, t: jprefill(cfg, p, {"tokens": t}, RT, max_len=horizon,
                                             full_cache=full),
                       params, jnp.asarray(tokens))(params, jnp.asarray(tokens))
    gl, gst = tprefill(tcfg, tparams, {"tokens": torch.from_numpy(tokens)}, TRT,
                       max_len=horizon, full_cache=full)
    specs = jlayer_specs(cfg, seq_len=S)
    kinds = tcfg.mixer_kinds()

    def check(got_logits, want_logits, got_state, want_state, what):
        np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                                   atol=MODEL_TOL, rtol=MODEL_TOL, err_msg=what)
        want = jax_layers(want_state["caches"], cfg, specs)
        assert len(got_state["caches"]) == len(want) == tcfg.n_layers
        for i, (g, w) in enumerate(zip(got_state["caches"], want)):
            keys = {"k", "v", "pos"} if kinds[i] == "local" else {"conv", "h"}
            assert set(g) == set(w) == keys, (what, i)
            for k in keys:
                if k == "pos":
                    np.testing.assert_array_equal(g[k].numpy(), w[k][0] if w[k].ndim > 1
                                                  else w[k], err_msg=f"{what} layer {i}")
                else:
                    np.testing.assert_allclose(g[k].numpy(), w[k], atol=MODEL_TOL,
                                               rtol=MODEL_TOL, err_msg=f"{what} layer {i} {k}")
        assert got_state["t"] == int(want_state["t"])

    check(gl, wl, gst, wst, "prefill")
    ring = gst["caches"][kinds.index("local")]["k"].shape[1]
    assert ring == (horizon if full else min(cfg.sliding_window, horizon))
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
    for kind, c in zip(tcfg.mixer_kinds(), st["caches"]):
        if kind == "local":
            assert c["k"].shape == (3, 40, 1, tcfg.head_dim) and c["k"].dtype == torch.bfloat16
            continue
        assert c["conv"].shape == (3, 3, tcfg.rglru_width)
        assert c["conv"].dtype == torch.bfloat16
        assert c["h"].shape == (3, tcfg.rglru_width) and c["h"].dtype == torch.float32


# ------------------------------------------------------------------- serving
def prompts_of(cfg):
    rng = np.random.RandomState(7)
    return [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32) for n in LENGTHS]


@pytest.fixture(scope="module")
def jax_engine(model):
    """JAX's dense engine over LENGTHS (paged=None picks it for the hybrid):
    its tokens and stats."""
    cfg, params, _, _, _ = model
    prompts = prompts_of(cfg)
    je = JServeEngine(cfg, params, RT, JEngineConfig(max_slots=3))
    assert not je.paged
    rids = [je.submit(p, NEW) for p in prompts]
    out = je.run()
    return prompts, [np.asarray(out[r]) for r in rids], je.stats, rids


def test_dense_engine_matches_jax(model, jax_engine):
    """ServeEngine with paged=None serves the hybrid dense: greedy tokens
    identical to JAX's dense engine, with JAX's kv_bytes (the local rings
    and the recurrent share); the three requests share one batch, and each
    equals its run alone."""
    cfg, _, tcfg, tparams, _ = model
    prompts, want, jstats, jrids = jax_engine
    eng = ServeEngine(tcfg, tparams, TRT, EngineConfig(max_slots=3), device="cpu")
    assert not eng.paged and eng.kv_pool_bytes_per_device() == 0
    rids = [eng.submit(p, NEW) for p in prompts]
    assert eng.step()["finished"] == rids              # one (length, max_new) batch
    assert not eng.busy
    out = eng.run_finalize()
    for r, jr, w in zip(rids, jrids, want):
        np.testing.assert_array_equal(out[r], w, err_msg=f"request {r}")
        assert eng.stats["kv_bytes"][r] == jstats["kv_bytes"][jr] > 0
    assert eng.stats["kv_bytes"][rids[0]] == jdense_kv_bytes(cfg, RT, len(prompts[0]) + NEW)
    for r, p in zip(rids, prompts):
        alone = ServeEngine(tcfg, tparams, TRT, EngineConfig(max_slots=3), device="cpu")
        a = alone.submit(p, NEW)
        np.testing.assert_array_equal(alone.run()[a], out[r], err_msg=f"alone {r}")


def test_prompt_past_the_window_matches_teacher_forced_argmax(model):
    """70 tokens, past the reduced 64 window and not a multiple of it: the
    port's ring keeps position p at row p % 64 (JAX's ring is not exact
    here), and the greedy tokens equal the port's own teacher-forced argmax
    at every step."""
    cfg, _, tcfg, tparams, _ = model
    rng = np.random.RandomState(8)
    tokens = rng.randint(0, cfg.vocab_size, (2, 70)).astype(np.int32)
    out, state = generate(tcfg, tparams, {"tokens": tokens}, TRT, NEW)
    assert out.shape == (2, NEW) and state["t"] == 70 + NEW - 1
    np.testing.assert_array_equal(out.numpy(),
                                  teacher_forced_argmax(tcfg, tparams, tokens, out).numpy())


def test_paged_serving_and_the_pipeline_refuse_the_hybrid(model):
    """The RG-LRU state is no KV cache: paged=True raises JAX's ValueError,
    as do generate(paged=True) and pricing a pool for it, and the paged pool
    refuses its layers; the pipeline refuses patterned storage, as JAX's
    does."""
    _, _, tcfg, tparams, _ = model
    with pytest.raises(ValueError, match="non-KV decode state"):
        ServeEngine(tcfg, tparams, TRT, EngineConfig(), paged=True, device="cpu")
    with pytest.raises(ValueError, match="non-KV decode state"):
        generate(tcfg, tparams, {"tokens": np.zeros((1, 4), np.int32)}, TRT, 2, paged=True)
    with pytest.raises(ValueError, match="no KV pool"):
        EngineConfig.capacity(64, 8, pool_bytes=1 << 20, cfg=tcfg)
    with pytest.raises(NotImplementedError, match="attention mixers only"):
        init_stack_pool(tcfg, TRT, layer_specs(tcfg, seq_len=16), 4, 8, device="cpu")
    with pytest.raises(ValueError, match="patterned parameter storage"):
        pipeline_fns(tcfg, TRT)


@pytest.mark.parametrize("argv,expect", [
    ([], "dense: 8 tokens"),
    (["--paged", "--requests", "3"], "dense state: bytes/request="),
])
def test_launcher_serves_the_hybrid_dense_on_cpu(argv, expect, capsys):
    launch_serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2", "--new-tokens", "4",
                       "--prompt-len", "8", "--temperature", "0"] + argv)
    out = capsys.readouterr().out
    assert "recurrentgemma-2b-reduced" in out and expect in out, out
