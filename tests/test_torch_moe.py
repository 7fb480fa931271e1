"""The port's MoE family against the JAX package, on the CPU in f32, at
reduced sizes.

* ``moe_apply``: output (1e-5), router aux (1e-6) and the kept (token,
  expert) slots against JAX's, with drops (cf 1.0 and 0.5), without (cf =
  E), at a decode-sized call and with planted router ties (the lower expert
  id wins, as ``jax.lax.top_k`` picks); in bf16 the same kept slots and aux,
  and outputs within one ulp of JAX's, nearly all bitwise, which the same
  function computed in f32 and rounded once fails.
* Reduced qwen3-moe (routed only), moonshot (a shared expert) and arctic (a
  dense residual FFN): ``lm.forward``'s logits and aux (1e-4) and
  ``loss_fn``'s total against JAX's; ``params_from_jax`` on their trees,
  nested and flat.
* Serving reduced qwen3-moe: the port's ``ServeEngine`` against JAX's, by
  whole-prompt and by chunked admission, greedy tokens identical (capacity
  couples the rows, so both engines feed the same inactive rows);
  ``paged=False`` and ``train.serve.generate`` against JAX's ``generate``;
  the "expert capacity" warning; expert-parallel ``moe_apply`` and MoE
  pipeline stages raise, naming their ROADMAP items.

The JAX engines and forwards compile once per config (module fixtures).
"""
import functools
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models import Runtime, init_params
from repro.models import forward as jforward
from repro.models import loss_fn as jloss_fn
from repro.models import moe as jmoe
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServeEngine as JServeEngine
from repro.train.serve import generate as jgenerate
from repro_torch.checkpoint import params_from_jax
from repro_torch.checkpoint.convert import flatten, params_to_numpy
from repro_torch.configs import get_reduced as t_get_reduced
from repro_torch.models import Runtime as TRuntime
from repro_torch.models import forward as tforward
from repro_torch.models import loss_fn as tloss_fn
from repro_torch.models import moe as tmoe
from repro_torch.models import pipeline_fns
from repro_torch.models.attention import null_writer
from repro_torch.models.stack import stack_stage_apply
from repro_torch.serve import EngineConfig, ServeEngine
from repro_torch.train.serve import generate

# pytest-xdist runs several workers on one machine: give torch this worker's share
# of the cores (oversubscribed, the torch side runs many times slower)
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

RT = Runtime(dtype=jnp.float32, chunk_q=32)
TRT = TRuntime(dtype=torch.float32)
MOE = ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b", "arctic-480b")
ENGINE = dict(max_slots=3, page_size=8, num_pages=49, max_len=64, inner_steps=4)
# four requests over three slots: slots empty and refill (two lengths, two
# JAX prefill programs)
LENGTHS = ((17, 0), (9, 0), (17, 1), (9, 1))
NEW = 6


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(name):
        if name not in cache:
            cfg, tcfg = get_reduced(name), t_get_reduced(name)
            key = jax.random.PRNGKey(0)
            params = compiled(lambda k: init_params(cfg, k), key)(key)
            tree = jax.tree.map(np.asarray, params)
            cache[name] = (cfg, params, tcfg, params_from_jax(tree, tcfg, device="cpu"), tree)
        return cache[name]

    return get


def compiled(fn, *args):
    """``fn`` jitted for ``args``' shapes, with XLA's backend optimisation off
    (a fraction of the compile time of these small programs) and without
    excess precision: by default XLA's CPU compiler keeps f32 between fused
    bf16 operations (the router's bf16 logits, say), where the program, and
    JAX run op by op, round each result to its dtype."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0,
                          "xla_allow_excess_precision": False})


def prompt(cfg, n, seed=0):
    return np.random.RandomState(seed + n).randint(0, cfg.vocab_size, (n,)).astype(np.int32)


# ----------------------------------------------------------------- moe_apply
def jax_keep(p, x, top_k, cf):
    """JAX's local ``moe_apply`` routing steps (``repro/models/moe.py``):
    top-k, stable sort by expert, ``searchsorted`` group starts, ``pos < C``.
    Returns (slot order, sorted experts, keep)."""
    xt = x.reshape(-1, x.shape[-1])
    T, E = xt.shape[0], p["w_up"].shape[0]
    probs = jax.nn.softmax((xt @ p["router"].astype(xt.dtype)).astype(jnp.float32), axis=-1)
    _, gate_idx = jax.lax.top_k(probs, top_k)
    le = gate_idx.reshape(-1)
    order = jnp.argsort(le, stable=True)
    le_s = le[order]
    start = jnp.searchsorted(le_s, jnp.arange(E + 1, dtype=le_s.dtype))
    pos = jnp.arange(T * top_k) - start[le_s]
    return order, le_s, pos < jmoe.capacity(T, top_k, E, cf)


def jax_kept_pairs(p, x, top_k, cf):
    """The (token, expert) slots JAX's routing keeps, sorted."""
    fn = functools.partial(jax_keep, top_k=top_k, cf=cf)
    order, le_s, keep = (np.asarray(a) for a in compiled(fn, p, x)(p, x))
    pairs = np.stack([(order // top_k)[keep], le_s[keep]], axis=1)
    return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]


# (T, E, k, capacity factor, gated, planted ties)
APPLY = [(24, 4, 2, 1.0, True, False), (24, 8, 2, 0.5, False, False),
         (16, 4, 2, 4.0, True, False), (4, 16, 2, 1.25, True, False),
         (24, 4, 1, 1.0, True, True), (24, 4, 2, 0.5, True, True)]


def apply_case(T, E, k, gated, ties, d, f):
    """Weights and input from a seed; with planted ties expert e + E/2's
    router column is expert e's, so every probability ties with another."""
    rng = np.random.RandomState(T + E)
    shapes = {"router": (d, E), "w_up": (E, d, f), "w_down": (E, f, d), "w_gate": (E, d, f)}
    p = {n: (rng.randn(*s) / np.sqrt(s[-2])).astype(np.float32) for n, s in shapes.items()
         if gated or n != "w_gate"}
    if ties:
        p["router"][:, E // 2:] = p["router"][:, :E // 2]
    tp = tmoe.MoE(*(torch.from_numpy(p[n]) if n in p else None
                    for n in ("router", "w_up", "w_down", "w_gate")))
    return p, tp, rng.randn(2, T // 2, d).astype(np.float32)


@pytest.mark.parametrize("T,E,k,cf,gated,ties", APPLY,
                         ids=[f"T{t}-E{e}-k{k}-cf{c}-g{int(g)}-ties{int(ti)}"
                              for t, e, k, c, g, ti in APPLY])
def test_moe_apply_matches_jax(T, E, k, cf, gated, ties):
    """Output, aux and kept slots against JAX's, in f32. With planted ties
    the stable sort must put the lower id first."""
    d = 32
    p, tp, x = apply_case(T, E, k, gated, ties, d, 48)
    args = (p, jnp.asarray(x))
    want, want_aux = compiled(functools.partial(
        jmoe.moe_apply, top_k=k, capacity_factor=cf, gated=gated), *args)(*args)
    got, aux = tmoe.moe_apply(tp, torch.from_numpy(x), top_k=k, capacity_factor=cf,
                              gated=gated)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert abs(float(aux) - float(want_aux)) < 1e-6
    routing = tmoe.route(tp, torch.from_numpy(x).reshape(T, d), top_k=k, capacity_factor=cf)
    pairs = routing.kept_pairs().numpy()
    np.testing.assert_array_equal(pairs, jax_kept_pairs(p, jnp.asarray(x), k, cf))
    if cf < E:
        assert len(pairs) < T * k                      # the case drops slots
    if ties:
        probs = routing.probs.numpy()
        np.testing.assert_array_equal(probs[:, :E // 2], probs[:, E // 2:])
        assert (routing.gate_idx[:, 0] < E // 2).all()  # the lower id of each tie


# (T, E, k, capacity factor, gated, planted ties) in bf16: drops, top-8 of 16
# (eight rounded adds a token), a decode-sized call, ties
APPLY_BF16 = [(24, 4, 2, 1.0, True, False), (24, 8, 2, 0.5, False, False),
              (64, 16, 8, 1.25, True, False), (4, 16, 2, 1.25, True, False),
              (24, 4, 2, 0.5, True, True)]


def ulp_agreement(got, want):
    """(share of elements not bitwise equal, whether each is within one
    bf16 ulp of the other: 2**-7 of the larger magnitude)."""
    bound = 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want))
    return float(np.mean(got != want)), bool((np.abs(got - want) <= bound).all())


@pytest.mark.parametrize("T,E,k,cf,gated,ties", APPLY_BF16,
                         ids=[f"T{t}-E{e}-k{k}-cf{c}-g{int(g)}-ties{int(ti)}"
                              for t, e, k, c, g, ti in APPLY_BF16])
def test_moe_apply_bf16_matches_jax(T, E, k, cf, gated, ties):
    """In bf16 (router logits, expert products, silu, gate weight and each
    of the combine's adds rounded to bf16, as JAX's program does): kept
    slots identical, aux within 1e-6, at most 1% of the outputs differ from
    JAX's, each by at most one ulp. The same function in f32, rounded to
    bf16 once at the end, differs in far more (about half), so a step that
    skipped its bf16 rounding would fail."""
    d = 64
    p, tp, x = apply_case(T, E, k, gated, ties, d, 96)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want, want_aux = compiled(functools.partial(
        jmoe.moe_apply, top_k=k, capacity_factor=cf, gated=gated), p, xb)(p, xb)
    want = np.asarray(want.astype(jnp.float32))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got, aux = tmoe.moe_apply(tp, xt, top_k=k, capacity_factor=cf, gated=gated)
    assert got.dtype == torch.bfloat16
    differ, within = ulp_agreement(got.float().numpy(), want)
    assert differ <= 0.01 and within, (differ, within)
    assert abs(float(aux) - float(want_aux)) < 1e-6
    routing = tmoe.route(tp, xt.reshape(T, d), top_k=k, capacity_factor=cf)
    np.testing.assert_array_equal(routing.kept_pairs().numpy(),
                                  jax_kept_pairs(p, xb, k, cf))
    if ties:
        assert (routing.gate_idx[:, 0] < E // 2).all()
    in_f32, _ = tmoe.moe_apply(tp, xt.float(), top_k=k, capacity_factor=cf, gated=gated)
    assert ulp_agreement(in_f32.to(torch.bfloat16).float().numpy(), want)[0] > 0.2


@pytest.mark.parametrize("active,lengths,want", [
    ([True, False, True, False], [5, 0, 9, 0], [0, 3, 2, 3]),
    ([True, True, True], [5, 7, 63], [0, 1, 2]),
    ([True, False, True], [64, 0, 3], [1, 1, 2]),     # row 0 past the table: null page
], ids=["inactive", "all-active", "past-the-table"])
def test_null_writer_gives_the_null_page_one_writer(active, lengths, want):
    """Every decode row that writes the null page's (0, 0) writes the last
    such row's K/V (what JAX's scatter and the CPU's in-order write leave
    there), so a MoE row attending it reads the same on the card."""
    tables = torch.ones(len(active), 4, dtype=torch.int32)       # 4 pages of 16
    got = null_writer(tables, torch.tensor(lengths, dtype=torch.int32),
                      torch.tensor(active), 16)
    assert got.tolist() == want


def test_expert_parallel_moe_raises():
    p = tmoe.init_moe(torch.Generator().manual_seed(0), 8, 16, 4, True, torch.float32)
    with pytest.raises(NotImplementedError, match="item 6"):
        tmoe.moe_apply(p, torch.zeros(1, 2, 8), top_k=2, capacity_factor=1.0, gated=True,
                       axis_name="model")


def test_moe_pipeline_stages_raise(models):
    _, _, tcfg, tparams, _ = models("qwen3-moe-30b-a3b")
    with pytest.raises(NotImplementedError, match="item 7"):
        pipeline_fns(tcfg, TRT)
    with pytest.raises(NotImplementedError, match="item 7"):
        stack_stage_apply(tcfg, list(tparams.stack.layers), torch.zeros(1, 4, tcfg.d_model),
                          TRT, None)


# -------------------------------------------------------------- whole model
@pytest.mark.parametrize("name", MOE)
def test_forward_and_loss_match_jax(models, name):
    """lm.forward's logits and summed router aux (1e-4) and loss_fn's total
    (router_aux_coef x aux included) against JAX's, with a masked label."""
    cfg, params, tcfg, tparams, _ = models(name)
    tokens = np.stack([prompt(cfg, 20), prompt(cfg, 20, seed=1)])
    labels = np.roll(tokens, -1, axis=1)
    labels[0, -3:] = -1
    batch = {"tokens": tokens, "labels": labels}
    args = (params, jax.tree.map(jnp.asarray, batch))
    (jl, jaux), (jtotal, _) = compiled(lambda p, b: (
        jforward(cfg, p, b, RT), jloss_fn(cfg, p, b, RT)), *args)(*args)
    tl, taux = tforward(tcfg, tparams, {"tokens": torch.from_numpy(tokens)}, TRT)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    assert float(jaux) > 0 and abs(float(taux) - float(jaux)) < 1e-4
    ttotal, metrics = tloss_fn(tcfg, tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
                               TRT)
    assert abs(float(ttotal) - float(jtotal)) < 1e-4
    assert abs(float(metrics["aux"]) - float(jaux)) < 1e-4


@pytest.mark.parametrize("layout", ["nested", "flat"])
@pytest.mark.parametrize("name", MOE)
def test_params_from_jax_carries_moe_trees(models, name, layout):
    """Router, expert stacks and the extra MLP arrive bitwise, and
    params_to_numpy gives the JAX tree back, nested or from flat keys."""
    cfg, _, tcfg, _, tree = models(name)
    src = tree if layout == "nested" else flatten(tree)
    tp = params_from_jax(src, tcfg, device="cpu")
    layer = tree["stack"]["g0"]["p0"]
    assert ("extra_mlp" in layer) == bool(cfg.n_shared_experts or cfg.dense_residual)
    assert layer["ffn"]["w_up"].shape == (cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff)
    back = flatten(params_to_numpy(tp))
    want = flatten(tree)
    assert set(back) == set(want)
    for key in want:
        np.testing.assert_array_equal(back[key], want[key], err_msg=key)


# ------------------------------------------------------------------ serving
def jax_engine_run(cfg, params, ecfg):
    eng = JServeEngine(cfg, params, RT, JEngineConfig(**ecfg))
    rids = [eng.submit(prompt(cfg, n, seed), NEW) for n, seed in LENGTHS]
    out = eng.run()
    return [np.asarray(out[r]) for r in rids]


@pytest.fixture(scope="module")
def jax_runs(models):
    cfg, params, _, _, _ = models("qwen3-moe-30b-a3b")
    runs = {}

    def get(mode):
        if mode not in runs:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")          # the chunked run's warning
                runs[mode] = jax_engine_run(cfg, params, ADMISSION[mode])
        return runs[mode]

    return get


ADMISSION = {"whole": ENGINE, "chunked": dict(ENGINE, prefill_chunk=8)}


@pytest.mark.parametrize("mode", sorted(ADMISSION))
def test_engine_tokens_identical_to_jax(models, jax_runs, mode):
    """Four requests over three slots, whole-prompt (exact shapes) or in
    8-token chunks: the port's greedy streams equal JAX's engine's. Rows of
    emptied and still-prefilling slots route through the experts beside the
    active ones, so this holds only because both feed the same rows."""
    cfg, _, tcfg, tparams, _ = models("qwen3-moe-30b-a3b")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = ServeEngine(tcfg, tparams, TRT, EngineConfig(**ADMISSION[mode]), device="cpu")
    rids = [eng.submit(prompt(cfg, n, seed), NEW) for n, seed in LENGTHS]
    out = eng.run()
    for rid, want in zip(rids, jax_runs(mode)):
        np.testing.assert_array_equal(out[rid], want, err_msg=f"request {rid}")
    if mode == "chunked":
        assert eng.stats["prefill_chunks"] == sum(-(-n // 8) for n, _ in LENGTHS)


def test_dense_generation_matches_jax_generate(models):
    """ServeEngine(paged=False) batches two same-shape requests into one
    generation over ring caches; both it and train.serve.generate equal
    JAX's generate over that batch."""
    cfg, params, tcfg, tparams, _ = models("qwen3-moe-30b-a3b")
    prompts = np.stack([prompt(cfg, 14), prompt(cfg, 14, seed=1)])
    want, _ = jgenerate(cfg, params, {"tokens": jnp.asarray(prompts)}, RT, NEW)
    got, _ = generate(tcfg, tparams, {"tokens": torch.from_numpy(prompts)}, TRT, NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    eng = ServeEngine(tcfg, tparams, TRT, EngineConfig(**ENGINE), paged=False, device="cpu")
    rids = [eng.submit(p, NEW) for p in prompts]
    first = eng.step()
    assert first["finished"] == rids
    out = eng.run_finalize()
    for b, rid in enumerate(rids):
        np.testing.assert_array_equal(out[rid], np.asarray(want[b]))


@pytest.mark.parametrize("over", [dict(prefill_bucket=8), dict(prefill_chunk=4),
                                  dict(prefix_cache=True)],
                         ids=["bucket", "chunk", "prefix"])
def test_engine_warns_on_moe_bucketed_or_chunked_prefill(models, over):
    """As JAX's engine: MoE capacity counts pad and chunk rows, so bucketed,
    chunked or prefix-cached prefill is not token-exact against an
    exact-shape run; exact shapes and a dense config give no warning."""
    _, _, tcfg, tparams, _ = models("qwen3-moe-30b-a3b")
    ecfg = dict(max_slots=1, page_size=8, num_pages=17, max_len=32)
    with pytest.warns(UserWarning, match="expert capacity"):
        ServeEngine(tcfg, tparams, TRT, EngineConfig(**ecfg, **over), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ServeEngine(tcfg, tparams, TRT, EngineConfig(**ecfg), device="cpu")
        ServeEngine(tcfg, tparams, TRT, EngineConfig(**ecfg, **over), paged=False,
                    device="cpu")
