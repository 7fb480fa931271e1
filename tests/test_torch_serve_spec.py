"""The port's speculative decoding against the JAX package's, on the CPU in
f32 (plain attention), at reduced sizes.

* Drafters: ``ngram_draft`` on fixed cases and on seeded random contexts, and
  ``paired_drafter_cfg`` field by field, against JAX's.
* ``lm.verify_step_paged``: reduced granite-8b and gemma3-1b (window 64),
  pools at f32, int8 and fp8 holding the same values on both sides, three
  slots (two at different lengths, one at ``q_len`` 0), T = 5: logits within
  1e-4 and the same argmax as JAX's, and the pool rows the pass writes
  against JAX's (f32 within 2e-5; codes within one code step, scales within
  the codec's rounding: ROADMAP queue 3's eager/jit gap).
* The reference's T = 1 claim on the port: a verify pass of one row is one
  ``decode_step_paged``, logits and pools bitwise, and only the decode step
  advances ``lengths``. At T = k the rows reproduce k sequential decode
  steps: the token chain exactly, the logits within 1e-4.
* The engine: the vocab-2 prompt-lookup scenario and the paired model
  drafter (JAX's drafter weights) against JAX's spec engine: the same tokens
  and the same spec counters, equal to the port's spec-off tokens and to
  each request alone. Then the port against its own spec-off engine: self-
  drafting (acceptance > 0.8, > 2 tokens a verify), the rollback under
  optimistic eviction with more verify rows than decode steps a tick (the
  pages must cover the verify rows, ``_lookahead``), prompt lookup with the
  prefix cache and chunked prefill, gemma3-1b's window, int8 and fp8 pools.
* The six configurations the engine refuses, and the launcher's ``--spec``.

One JAX spec engine runs per drafter kind, every prompt padded to one
bucket (one prefill program a model), and JAX's verify passes compile with
XLA's backend optimisation off.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.configs.base import reduced as jreduced
from repro.models import Runtime, init_params
from repro.models import init_paged_state as jinit_paged_state
from repro.models import verify_step_paged as jverify_step_paged
from repro.models.stack import build_segments
from repro.models.stack import layer_specs as jlayer_specs
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve.spec import ngram_draft as jngram_draft
from repro.serve.spec import paired_drafter_cfg as jpaired_drafter_cfg
from repro_torch.checkpoint import params_from_jax
from repro_torch.configs import get_reduced as t_get_reduced
from repro_torch.configs.base import reduced
from repro_torch.kernels.paged_attention import quant
from repro_torch.launch import serve as launch_serve
from repro_torch.models import Runtime as TRuntime
from repro_torch.models import decode_step_paged, verify_step_paged
from repro_torch.serve import (
    EngineConfig,
    ServeEngine,
    ngram_draft,
    paged_supported,
    paired_drafter_cfg,
)
from repro_torch.serve.engine import SPEC_COUNTERS
from test_torch_serve_engine import QUANT_REL_TOL

# pytest-xdist runs several workers on one machine: give torch this worker's share
# of the cores (oversubscribed, the torch side runs many times slower)
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

RT = Runtime(dtype=jnp.float32, chunk_q=32)
TRT = TRuntime(dtype=torch.float32)
LOGIT_TOL = 1e-4                 # JAX's own bound for verify rows against decode steps
POOL_TOL = 2e-5                  # f32 K/V rows: another summation order
# every prompt here pads to one bucket: one JAX prefill program a model
ECFG = dict(max_slots=2, page_size=8, num_pages=33, max_len=64, inner_steps=4,
            prefill_bucket=32)


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(arch, **over):
        key = (arch, tuple(sorted(over.items())))
        if key not in cache:
            cfg, tcfg = get_reduced(arch), t_get_reduced(arch)
            if over:
                cfg, tcfg = jreduced(cfg, **over), reduced(tcfg, **over)
            params = init_params(cfg, jax.random.PRNGKey(0))
            tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
            cache[key] = (cfg, params, tcfg, tparams)
        return cache[key]

    return get


# ------------------------------------------------------------------ drafters
NGRAM_CASES = [
    ([7, 1, 2, 3, 9, 8, 1, 2, 3], 2, 3), ([7, 1, 2, 3, 9, 8, 1, 2, 3], 1, 3),
    ([1, 2, 3, 1, 2, 3], 5, 3), ([1, 2, 5, 4, 2, 9, 1, 2], 1, 3),
    ([1, 2, 5, 0, 1, 2, 8, 0, 1, 2], 1, 3), ([0, 1] * 5, 3, 3), ([1, 2, 3, 4], 3, 3),
    ([5], 3, 3), ([1, 2, 1, 2], 0, 3), ([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5], 4, 1),
    ([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5], 4, 2), ([4, 4, 4, 4], 6, 3),
]


def test_ngram_draft_matches_jax():
    """Fixed cases (periodic tails, no match, n = 1..3, k = 0), then 400
    seeded random contexts over small vocabularies, where matches are
    common: the same proposal as JAX's, token for token."""
    cases = [(np.array(c, np.int32), k, n) for c, k, n in NGRAM_CASES]
    rng = np.random.RandomState(0)
    for _ in range(400):
        vocab = int(rng.randint(2, 9))
        ctx = rng.randint(0, vocab, (int(rng.randint(0, 40)),)).astype(np.int32)
        cases.append((ctx, int(rng.randint(0, 8)), int(rng.randint(1, 4))))
    matched = 0
    for ctx, k, n in cases:
        got, want = ngram_draft(ctx, k, n), jngram_draft(ctx, k, n)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=f"{ctx.tolist()} k={k} n={n}")
        matched += len(want) > 0
    assert matched > 200                       # the random half exercises matches
    np.testing.assert_array_equal(ngram_draft(np.array([0, 1] * 5, np.int32), 3), [0, 1, 0])


@pytest.mark.parametrize("name", ["granite-8b", "gemma3-1b", "granite-34b", "survey-demo-100m"])
def test_paired_drafter_cfg_matches_jax(name):
    for over in ({}, {"n_layers": 2}):
        got = dataclasses.asdict(paired_drafter_cfg(t_get_reduced(name), **over))
        want = dataclasses.asdict(jpaired_drafter_cfg(get_reduced(name), **over))
        assert got == want
    dcfg = paired_drafter_cfg(t_get_reduced(name))
    assert dcfg.n_layers == 1 and paged_supported(dcfg)


# -------------------------------------------------------------- verify pass
def random_pools(tcfg, kv_dtype, num_pages, page, seed):
    """Port pools holding seeded random K/V rows (page 0, the null page, stays
    zero); over int8 / fp8 the codes and scales of ``kv_quantize``."""
    rng = np.random.RandomState(seed)
    shape = (tcfg.n_layers, num_pages, page, tcfg.n_kv_heads, tcfg.head_dim)
    pools = {}
    for name in "kv":
        x = torch.tensor(rng.randn(*shape), dtype=torch.float32)
        x[:, 0] = 0
        if not kv_dtype:
            pools[name] = x
            continue
        pools[name], pools[f"{name}sc"] = quant.kv_quantize(x, storage(kv_dtype))
    return pools


def storage(kv_dtype):
    return quant.kv_storage_dtype(kv_dtype, torch.float32)


def leaf_bits(t: torch.Tensor) -> np.ndarray:
    """A pool leaf as numpy: fp8 codes as their bytes (numpy has no fp8)."""
    return (t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t).numpy()


def to_jax_pools(cfg, specs, tpools, template):
    """The port's stacked pools in JAX's segment layout (``template`` from
    JAX's ``init_paged_state``)."""
    names = {"kp": "k", "vp": "v", "ksc": "ksc", "vsc": "vsc"}
    out, layer = [], 0
    for seg, unit in zip(build_segments(cfg, specs), template):
        leaves = {j: {key: [] for key in unit[f"p{j}"]} for j in range(len(seg.unit_specs))}
        for _ in range(seg.repeats):
            for j in range(len(seg.unit_specs)):
                for key in leaves[j]:
                    leaf = leaf_bits(tpools[names[key]][layer])
                    leaves[j][key].append(leaf.view(unit[f"p{j}"][key].dtype))
                layer += 1
        out.append({f"p{j}": {key: jnp.asarray(np.stack(v)) for key, v in d.items()}
                    for j, d in leaves.items()})
    assert layer == cfg.n_layers
    return out


def from_jax_pools(cfg, specs, jpools):
    """JAX's segment-layout pools as the port's stacked numpy arrays."""
    names = {"kp": "k", "vp": "v", "ksc": "ksc", "vsc": "vsc"}
    layers = {}
    for seg, unit in zip(build_segments(cfg, specs), jpools):
        for r in range(seg.repeats):
            for j in range(len(seg.unit_specs)):
                for key, leaf in unit[f"p{j}"].items():
                    a = np.asarray(leaf[r])
                    layers.setdefault(names[key], []).append(
                        a.view(np.uint8) if a.dtype.itemsize == 1 and a.dtype != np.int8 else a)
    return {k: np.stack(v) for k, v in layers.items()}


VERIFY_PAGE, VERIFY_PAGES, VERIFY_MAX_LEN = 8, 24, 64
VERIFY_LENGTHS = [13, 30, 21]      # the third slot has q_len 0
VERIFY_T = 5


def verify_case(tcfg, kv_dtype, seed=0):
    """Three slots' disjoint tables over random pools; (B, T) tokens."""
    rng = np.random.RandomState(seed + 1)
    P = VERIFY_MAX_LEN // VERIFY_PAGE
    tables = np.zeros((3, P), np.int32)
    tables[0, :3], tables[1, :5], tables[2, :4] = [3, 9, 1], [2, 10, 4, 12, 5], [6, 7, 8, 11]
    tokens = rng.randint(0, tcfg.vocab_size, (3, VERIFY_T)).astype(np.int32)
    q_len = np.array([VERIFY_T, VERIFY_T, 0], np.int32)
    pools = random_pools(tcfg, kv_dtype, VERIFY_PAGES, VERIFY_PAGE, seed)
    return pools, tables, tokens, q_len


@pytest.fixture(scope="module")
def jax_verify(models):
    """JAX's compiled verify pass on each (config, kv dtype), from the same
    pools: its logits and the pools after it."""
    cache = {}

    def get(name, kv_dtype):
        if (name, kv_dtype) not in cache:
            cfg, params, tcfg, _ = models(name)
            pools, tables, tokens, q_len = verify_case(tcfg, kv_dtype)
            rt = RT.replace(kv_dtype=kv_dtype)
            state = jinit_paged_state(cfg, 3, rt, num_pages=VERIFY_PAGES,
                                      page_size=VERIFY_PAGE, max_len=VERIFY_MAX_LEN)
            specs = jlayer_specs(cfg, seq_len=VERIFY_MAX_LEN)
            state = dict(state, caches=to_jax_pools(cfg, specs, pools, state["caches"]),
                         tables=jnp.asarray(tables),
                         lengths=jnp.asarray(VERIFY_LENGTHS, jnp.int32))
            args = (params, state, jnp.asarray(tokens), jnp.asarray(q_len))
            # XLA's backend optimisation off: a third of the compile time
            logits, st = jax.jit(lambda p, s, t, q: jverify_step_paged(
                cfg, p, s, t, q, rt, VERIFY_MAX_LEN)).lower(*args).compile(
                compiler_options={"xla_backend_optimization_level": 0})(*args)
            assert np.array_equal(np.asarray(st["lengths"]), VERIFY_LENGTHS)
            cache[name, kv_dtype] = (np.asarray(logits), from_jax_pools(cfg, specs, st["caches"]))
        return cache[name, kv_dtype]

    return get


VERIFY = [(n, kv) for n in ("granite-8b", "gemma3-1b") for kv in ("", "int8", "fp8")]


@pytest.mark.parametrize("name,kv_dtype", VERIFY, ids=[f"{n}-{kv or 'f32'}" for n, kv in VERIFY])
def test_verify_step_paged_matches_jax(models, jax_verify, name, kv_dtype):
    """The same pools, tables, lengths and (3, 5) tokens through both verify
    passes. The pool rows the pass writes (positions lengths .. lengths + 4
    of the two active slots) against JAX's: f32 within 2e-5; int8 codes at
    most one step apart and fp8 codes' values at most one e4m3 step; the rest
    of the pool untouched, and ``lengths`` too. Where no written code
    differs: scales within 1e-5 relative, the active rows' logits within
    1e-4 and the same argmax. JAX's compiled codec multiplies by the
    reciprocal of the code range (ROADMAP queue 3), so a code near a rounding
    edge can land one step from the port's; the later layers' rows then
    differ by that step's share (scales within 1e-3 relative), and the
    logits hold JAX's limit for a quantized pool's, ``QUANT_REL_TOL`` of
    max|logit|."""
    cfg, _, tcfg, tparams = models(name)
    want_logits, want_pools = jax_verify(name, kv_dtype)
    pools, tables, tokens, q_len = verify_case(tcfg, kv_dtype)
    before = {k: v.clone() for k, v in pools.items()}
    state = {"caches": pools, "tables": torch.from_numpy(tables),
             "lengths": torch.tensor(VERIFY_LENGTHS, dtype=torch.int32)}
    logits = verify_step_paged(tcfg, tparams, state, torch.from_numpy(tokens),
                               torch.from_numpy(q_len), TRT.replace(kv_dtype=kv_dtype),
                               VERIFY_MAX_LEN)
    assert logits.shape == want_logits.shape and logits.dtype == torch.float32
    assert state["lengths"].tolist() == VERIFY_LENGTHS
    written = np.zeros(pools["k"].shape[1:3], bool)                  # (N, page)
    for b in range(2):
        for pos in range(VERIFY_LENGTHS[b], VERIFY_LENGTHS[b] + VERIFY_T):
            written[tables[b, pos // VERIFY_PAGE], pos % VERIFY_PAGE] = True
    untouched = ~written
    untouched[0] = False                  # the null page takes the q_len-0 rows
    differ, scale_rel = 0, 0.0
    for key, pool in pools.items():
        got, want = leaf_bits(pool), want_pools[key]
        np.testing.assert_array_equal(got[:, untouched], leaf_bits(before[key])[:, untouched],
                                      err_msg=f"{key} rows the pass must not write")
        if not kv_dtype:
            np.testing.assert_allclose(got[:, written], want[:, written], atol=POOL_TOL,
                                       rtol=POOL_TOL, err_msg=key)
        elif key in ("ksc", "vsc"):
            g, w = got[:, written], want[:, written]
            scale_rel = max(scale_rel, float((np.abs(g - w) / np.abs(w)).max()))
        else:
            g = pool[:, written].float().numpy()
            w = torch.from_numpy(want[:, written]).view(pool.dtype).float().numpy()
            step = 1.0 if kv_dtype == "int8" else np.maximum(np.abs(w), 2.0 ** -6) * 2.0 ** -3
            assert (np.abs(g - w) <= step).all(), key
            differ += int((g != w).sum())
    V = tcfg.vocab_size
    got, want = logits[:2, :, :V].numpy(), want_logits[:2, :, :V]
    if differ:
        rel = np.abs(got - want).max(-1) / np.abs(want).max(-1)
        print(f"{name} {kv_dtype}: {differ} written codes one step from JAX's, scales "
              f"{scale_rel:.2e} and logits {rel.max():.2e} of max|logit| apart")
        assert scale_rel < 1e-3 and rel.max() < QUANT_REL_TOL[kv_dtype]
    else:
        assert scale_rel < 1e-5
        np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("name,kv_dtype", VERIFY, ids=[f"{n}-{kv or 'f32'}" for n, kv in VERIFY])
def test_verify_at_t1_is_decode_step_bitwise(models, name, kv_dtype):
    """The reference's claim, on the port: a verify pass of one row per slot
    (the third slot inactive) is one ``decode_step_paged`` — logits and every
    pool leaf bitwise — and only the decode step advances ``lengths``."""
    _, _, tcfg, tparams = models(name)
    rt = TRT.replace(kv_dtype=kv_dtype)
    pools, tables, tokens, _ = verify_case(tcfg, kv_dtype)
    active = torch.tensor([True, True, False])
    runs = {}
    for kind in ("decode", "verify"):
        state = {"caches": {k: v.clone() for k, v in pools.items()},
                 "tables": torch.from_numpy(tables),
                 "lengths": torch.tensor(VERIFY_LENGTHS, dtype=torch.int32)}
        tok = torch.from_numpy(tokens[:, 0].copy())
        if kind == "decode":
            logits = decode_step_paged(tcfg, tparams, state, tok, rt, VERIFY_MAX_LEN,
                                       active=active)
        else:
            logits = verify_step_paged(tcfg, tparams, state, tok[:, None],
                                       active.int(), rt, VERIFY_MAX_LEN)[:, 0]
        runs[kind] = (logits[:2], state)
    (ld, sd), (lv, sv) = runs["decode"], runs["verify"]
    assert torch.equal(ld, lv)
    for key in pools:
        # the null page takes the inactive slot's verify row: compare the rest
        assert torch.equal(sd["caches"][key][:, 1:], sv["caches"][key][:, 1:]), key
    assert sd["lengths"].tolist() == [VERIFY_LENGTHS[0] + 1, VERIFY_LENGTHS[1] + 1,
                                      VERIFY_LENGTHS[2]]
    assert sv["lengths"].tolist() == VERIFY_LENGTHS


TK = [("granite-8b", ""), ("gemma3-1b", ""), ("granite-8b", "int8"), ("granite-8b", "fp8")]


@pytest.mark.parametrize("name,kv_dtype", TK, ids=[f"{n}-{kv or 'f32'}" for n, kv in TK])
def test_verify_at_tk_matches_sequential_decode(models, name, kv_dtype):
    """One T = 4 verify pass over the port's own greedy chain against four
    sequential decode steps from the same pools: the argmax chain exactly at
    every row, the logits within 1e-4."""
    _, _, tcfg, tparams = models(name)
    rt = TRT.replace(kv_dtype=kv_dtype)
    pools, tables, tokens, _ = verify_case(tcfg, kv_dtype, seed=3)
    k, V = 4, tcfg.vocab_size

    def fresh():
        return {"caches": {key: v.clone() for key, v in pools.items()},
                "tables": torch.from_numpy(tables[:2]),
                "lengths": torch.tensor(VERIFY_LENGTHS[:2], dtype=torch.int32)}

    st, toks, seq = fresh(), [torch.from_numpy(tokens[:2, 0].copy())], []
    for _ in range(k):
        lg = decode_step_paged(tcfg, tparams, st, toks[-1], rt, VERIFY_MAX_LEN)
        seq.append(lg)
        toks.append(lg[:, :V].argmax(-1).int())
    chain = torch.stack(toks[:k], dim=1)                                  # (2, k)
    lv = verify_step_paged(tcfg, tparams, fresh(), chain,
                           torch.full((2,), k, dtype=torch.int32), rt, VERIFY_MAX_LEN)
    for j in range(k):
        assert torch.equal(lv[:, j, :V].argmax(-1).int(), toks[j + 1]), j
        np.testing.assert_allclose(lv[:, j].numpy(), seq[j].numpy(), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL, err_msg=f"row {j}")


# ------------------------------------------------------------------- engine
def drive(tcfg, tparams, ecfg, prompts, max_news, rt=TRT, **kw):
    eng = ServeEngine(tcfg, tparams, rt, ecfg, device="cpu", **kw)
    rids = [eng.submit(p, m) for p, m in zip(prompts, max_news)]
    out = eng.run()
    return eng, [out[r] for r in rids]


def jax_drive(cfg, params, ecfg, prompts, max_news, **kw):
    eng = JServeEngine(cfg, params, RT, ecfg, **kw)
    rids = [eng.submit(p, m) for p, m in zip(prompts, max_news)]
    out = eng.run()
    return eng, [np.asarray(out[r]) for r in rids]


def spec_prompts(vocab):
    """Staggered lengths plus one cyclic prompt."""
    rng = np.random.RandomState(2)
    base = rng.randint(0, vocab, (4,)).astype(np.int32)
    return ([np.tile(base, 4)] + [rng.randint(0, vocab, (n,)).astype(np.int32)
                                  for n in (11, 17, 6)], [10, 6, 9, 8])


def binary_prompts():
    rng = np.random.RandomState(7)
    return [rng.randint(0, 2, (n,)).astype(np.int32) for n in (12, 7, 15)], [24, 16, 20]


def assert_identical(tcfg, tparams, ecfg, prompts, max_news, on, want, eng, **kw):
    """Spec-on tokens == want (JAX's spec-on) == the port's spec-off tokens ==
    each request alone through the port's spec engine; the pool clean."""
    _, off = drive(tcfg, tparams, dataclasses.replace(ecfg, spec_tokens=0), prompts, max_news)
    for i, (p, m) in enumerate(zip(prompts, max_news)):
        np.testing.assert_array_equal(on[i], want[i], err_msg=f"req {i} vs JAX")
        np.testing.assert_array_equal(on[i], off[i], err_msg=f"req {i} vs spec-off")
        _, alone = drive(tcfg, tparams, ecfg, [p], [m], **kw)
        np.testing.assert_array_equal(on[i], alone[0], err_msg=f"req {i} alone")
    eng.pool.check()
    assert eng.pool.pages_in_use == 0


def test_spec_ngram_matches_jax(models):
    """The reference's anchored scenario: a vocab-2 model's greedy stream
    falls into short cycles, so prompt lookup lands hits. The port's spec
    engine gives JAX's tokens and JAX's three counters."""
    cfg, params, tcfg, tparams = models("granite-8b", name="granite-8b-bin", vocab_size=2)
    prompts, max_news = binary_prompts()
    je, want = jax_drive(cfg, params, JEngineConfig(spec_tokens=3, **ECFG), prompts, max_news)
    ecfg = EngineConfig(spec_tokens=3, **ECFG)
    eng, on = drive(tcfg, tparams, ecfg, prompts, max_news)
    assert_identical(tcfg, tparams, ecfg, prompts, max_news, on, want, eng)
    for key in SPEC_COUNTERS:
        assert eng.stats[key] == je.stats[key], key
    s = eng.stats
    assert s["spec_accepted_tokens"] > 0 and 0 < s["spec_accept_rate"] <= 1
    assert s["spec_verify_calls"] < sum(len(o) for o in on)
    assert s["spec_accept_rate"] == je.stats["spec_accept_rate"]
    assert s["spec_accepted_per_verify"] == je.stats["spec_accepted_per_verify"]


def test_spec_model_drafter_matches_jax(models):
    """The paired 1-layer drafter with JAX's drafter weights, on full-vocab
    random weights (drafts mostly rejected): JAX's tokens and counters."""
    cfg, params, tcfg, tparams = models("granite-8b")
    dcfg = jpaired_drafter_cfg(cfg)
    dparams = init_params(dcfg, jax.random.PRNGKey(1))
    tdcfg = paired_drafter_cfg(tcfg)
    tdparams = params_from_jax(jax.tree.map(np.asarray, dparams), tdcfg, device="cpu")
    prompts, max_news = spec_prompts(cfg.vocab_size)
    je, want = jax_drive(cfg, params, JEngineConfig(spec_tokens=3, spec_drafter="model", **ECFG),
                         prompts, max_news, draft_params=dparams, draft_cfg=dcfg)
    ecfg = EngineConfig(spec_tokens=3, spec_drafter="model", **ECFG)
    kw = dict(draft_params=tdparams, draft_cfg=tdcfg)
    eng, on = drive(tcfg, tparams, ecfg, prompts, max_news, **kw)
    assert_identical(tcfg, tparams, ecfg, prompts, max_news, on, want, eng, **kw)
    for key in SPEC_COUNTERS:
        assert eng.stats[key] == je.stats[key], key


def assert_same_as_spec_off(tcfg, tparams, ecfg, prompts, max_news, rt=TRT, **kw):
    eng, on = drive(tcfg, tparams, ecfg, prompts, max_news, rt=rt, **kw)
    _, off = drive(tcfg, tparams, dataclasses.replace(ecfg, spec_tokens=0), prompts,
                   max_news, rt=rt)
    for i, (a, b) in enumerate(zip(on, off)):
        np.testing.assert_array_equal(a, b, err_msg=f"req {i}")
    assert eng.stats["spec_verify_calls"] > 0
    eng.pool.check()
    return eng


def test_spec_self_draft_accepts_nearly_everything(models):
    """Drafter == target: only the remaining-token cap rejects, so every
    verify commits several tokens; this reaches the full-accept catch-up
    (the drafter one token behind) that partial acceptance never does."""
    _, _, tcfg, tparams = models("granite-8b")
    prompts, _ = spec_prompts(tcfg.vocab_size)
    eng = assert_same_as_spec_off(
        tcfg, tparams, EngineConfig(spec_tokens=3, spec_drafter="model", **ECFG), prompts,
        [22, 18, 21, 20], draft_params=tparams, draft_cfg=tcfg)
    s = eng.stats
    assert s["spec_accept_rate"] > 0.8, s["spec_accept_rate"]
    assert s["spec_accepted_per_verify"] > 2.0, s["spec_accepted_per_verify"]
    assert eng.pool.pages_in_use == 0


def test_spec_rollback_under_optimistic_eviction(models):
    """Optimistic policy, a pool that runs short (evictions), and 5 verify
    rows a tick against 2 decode steps: the pages must cover every verify row
    (a committed row on the null page would lose its KV), and
    ``PagePool.truncate`` hands back what the rejected rows reserved. Self-
    drafting, so most verify rows commit."""
    _, _, tcfg, tparams = models("granite-8b")
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, tcfg.vocab_size, (4,)).astype(np.int32) for _ in range(2)]
    tight = dict(max_slots=2, page_size=4, num_pages=10, max_len=48, inner_steps=2,
                 policy="optimistic")
    eng = assert_same_as_spec_off(
        tcfg, tparams, EngineConfig(spec_tokens=4, spec_drafter="model", **tight), prompts,
        [24, 16], draft_params=tparams, draft_cfg=tcfg)
    assert eng.stats.get("evictions", 0) > 0
    assert eng.stats["spec_accepted_per_verify"] > 2.0
    assert eng.pool.pages_in_use == 0


def test_spec_with_prefix_cache_and_chunked_prefill(models):
    """Prompt lookup with the radix prefix cache and chunked prefill: ticks
    with a prompt still chunking run the ordinary decode steps, the others
    verify, and the tokens do not change."""
    _, _, tcfg, tparams = models("granite-8b")
    rng = np.random.RandomState(6)
    sys_prompt = rng.randint(0, tcfg.vocab_size, (16,)).astype(np.int32)
    prompts = [np.concatenate([sys_prompt, rng.randint(0, tcfg.vocab_size, (s,))
                               .astype(np.int32)]) for s in (5, 3, 7)]
    mode = dict(ECFG, prefix_cache=True, prefill_chunk=8)
    eng = assert_same_as_spec_off(tcfg, tparams, EngineConfig(spec_tokens=3, **mode), prompts,
                                  [8, 10, 6])
    assert eng.stats["prefill_chunks"] > 0 and eng.stats["prefix_hits"] > 0
    assert eng.pool.pages_in_use == eng.prefix.pages_cached()


SPEC_POOLS = [("granite-8b", "int8", "ngram"), ("granite-8b", "fp8", "model"),
              ("gemma3-1b", "bf16", "ngram")]


@pytest.mark.parametrize("name,kv_dtype,drafter", SPEC_POOLS,
                         ids=[f"{n}-{kv}-{d}" for n, kv, d in SPEC_POOLS])
def test_spec_quantized_pools_and_window(models, name, kv_dtype, drafter):
    """Spec-on == spec-off over int8 and fp8 pools (the model drafter's pools
    quantized too) and past gemma3-1b's 64 window, at the vocab-2 width where
    drafts are accepted."""
    _, _, tcfg, tparams = models(name, name=f"{name}-bin", vocab_size=2)
    prompts, max_news = binary_prompts()
    if name == "gemma3-1b":
        prompts = [np.tile(p, 6)[:70] for p in prompts]
        max_news = [12, 10, 14]
    kw = dict(draft_params=tparams, draft_cfg=tcfg) if drafter == "model" else {}
    ecfg = EngineConfig(spec_tokens=3, spec_drafter=drafter, kv_dtype=kv_dtype,
                        **dict(ECFG, max_len=96, num_pages=40))
    eng = assert_same_as_spec_off(tcfg, tparams, ecfg, prompts, max_news, **kw)
    if kv_dtype != "bf16":
        assert eng._dev["caches"]["k"].dtype == storage(kv_dtype)
    assert eng.stats["spec_accepted_tokens"] > 0


# ------------------------------------------------------------------- gating
def test_spec_config_gating(models):
    _, _, tcfg, tparams = models("granite-8b")
    spec = dict(spec_tokens=3, **ECFG)
    for name in ("falcon-mamba-7b", "recurrentgemma-2b", "seamless-m4t-medium"):
        with pytest.raises(ValueError, match="paged"):
            ServeEngine(t_get_reduced(name), None, TRT, EngineConfig(**spec), device="cpu")
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(tcfg, tparams, TRT, EngineConfig(**spec), paged=False, device="cpu")
    with pytest.raises(ValueError, match="temperature"):
        ServeEngine(tcfg, tparams, TRT, EngineConfig(temperature=0.7, **spec), device="cpu")
    with pytest.raises(ValueError, match="spec_drafter"):
        ServeEngine(tcfg, tparams, TRT, EngineConfig(spec_drafter="medusa", **spec),
                    device="cpu")
    for mode in ({"prefix_cache": True}, {"prefill_chunk": 8}):
        with pytest.raises(ValueError, match="prefix_cache"):
            ServeEngine(tcfg, tparams, TRT, EngineConfig(spec_drafter="model", **mode, **spec),
                        device="cpu", draft_params=tparams, draft_cfg=tcfg)
    with pytest.raises(ValueError, match="draft_params"):
        ServeEngine(tcfg, tparams, TRT, EngineConfig(spec_drafter="model", **spec),
                    device="cpu")
    vis = t_get_reduced("phi-3-vision-4.2b")
    with pytest.raises(ValueError, match="ngram drafter"):
        ServeEngine(vis, None, TRT, EngineConfig(spec_drafter="model", **spec),
                    device="cpu", draft_params=tparams, draft_cfg=tcfg)


# ----------------------------------------------------------------- launcher
@pytest.mark.parametrize("drafter", ["ngram", "model"])
def test_launcher_serves_with_spec(drafter, capsys):
    launch_serve.main(["--arch", "granite-8b", "--paged", "--spec", "3", "--drafter", drafter,
                       "--device", "cpu", "--requests", "3", "--new-tokens", "5"])
    out = capsys.readouterr().out
    assert "granite-8b-reduced" in out
    assert f"spec: k=3 drafter={drafter} accept_rate=" in out
