"""The port's serve engine against the JAX package's, plus its own
invariants, all on the CPU in f32 (plain attention).

* Greedy identity with JAX: the same parameters, EngineConfig and prompts
  (lengths 20/90/37) through both engines give the same tokens, with the
  prefix cache off and on (a second run of the same prompts hits the cache),
  on reduced granite-8b (MQA and GQA) and gemma3-1b (window 64), and under
  the optimistic policy with preemption. A divergence is allowed only where
  the JAX top-2 logit margin at the first differing token is below 1e-4 — a
  tie in f32 — and the test prints it.
* Within the port: batched == alone at temperature 0.8; cache-on == cold.
* Host modules: the port's pool, scheduler and radix cache invariants.
* Rejections: each mode this slice leaves out raises NotImplementedError.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models import Runtime, forward, init_params
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.checkpoint import params_from_jax
from repro_torch.configs import get_reduced as t_get_reduced
from repro_torch.launch import serve as launch_serve
from repro_torch.models import Runtime as TRuntime
from repro_torch.serve import (
    EngineConfig,
    PagePool,
    PoolExhausted,
    PrefixCache,
    ReplicatedServeEngine,
    ServeEngine,
)

RT = Runtime(dtype=jnp.float32, chunk_q=32)
TRT = TRuntime(dtype=torch.float32)
BASE = dict(max_slots=2, page_size=8, num_pages=33, max_len=128, inner_steps=4,
            prefill_chunk=8)
LENGTHS = (20, 90, 37)
MARGIN = 1e-4


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(name, **over):
        key = (name, tuple(sorted(over.items())))
        if key not in cache:
            cfg, tcfg = get_reduced(name, **over), t_get_reduced(name, **over)
            params = init_params(cfg, jax.random.PRNGKey(0))
            tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg)
            cache[key] = (cfg, params, tcfg, tparams)
        return cache[key]

    return get


def prompts_for(cfg, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, (s,)).astype(np.int32) for s in LENGTHS]


def run_both(models, name, over, ecfg, max_new, runs=1):
    cfg, params, tcfg, tparams = models(name, **over)
    je = JServeEngine(cfg, params, RT, JEngineConfig(**ecfg))
    te = ServeEngine(tcfg, tparams, TRT, EngineConfig(**ecfg), device="cpu")
    outs = []
    for _ in range(runs):
        prompts = prompts_for(cfg)
        jr = [je.submit(p, max_new) for p in prompts]
        tr = [te.submit(p, max_new) for p in prompts]
        jo, to = je.run(), te.run()
        outs.append([(p, jo[a], to[b]) for p, a, b in zip(prompts, jr, tr)])
    return cfg, params, je, te, outs


def assert_same_or_tie(cfg, params, prompt, want, got):
    """Equal tokens, or a first difference at an f32 tie of the JAX logits."""
    if np.array_equal(want, got):
        return
    i = int(np.nonzero(want != got)[0][0])
    seq = np.concatenate([prompt, want[:i]])[None]
    logits, _ = forward(cfg, params, {"tokens": jnp.asarray(seq)}, RT)
    top2 = np.sort(np.asarray(logits[0, -1, : cfg.vocab_size]))[-2:]
    margin = float(top2[1] - top2[0])
    print(f"first divergence at token {i}: JAX top-2 margin {margin:.3e}")
    assert margin < MARGIN, (i, margin, want, got)


IDENTITY = [
    ("granite-8b", {}, False),
    ("granite-8b", {}, True),
    ("granite-8b", {"n_kv_heads": 2}, False),
    ("granite-8b", {"n_kv_heads": 2}, True),
    ("gemma3-1b", {}, False),
    ("gemma3-1b", {}, True),
]


@pytest.mark.parametrize("name,over,prefix", IDENTITY,
                         ids=[f"{n}{o}-prefix{p}" for n, o, p in IDENTITY])
def test_greedy_tokens_identical_to_jax(models, name, over, prefix):
    ecfg = dict(BASE, prefix_cache=prefix)
    cfg, params, je, te, outs = run_both(models, name, over, ecfg, 8,
                                         runs=2 if prefix else 1)
    for run in outs:
        for prompt, want, got in run:
            assert got.shape == (8,)
            assert_same_or_tie(cfg, params, prompt, want, got)
    assert te.stats["prefill_chunks"] == je.stats["prefill_chunks"]
    if prefix:                       # the second run adopts cached prompts
        assert te.stats["prefix_hits"] == je.stats["prefix_hits"] > 0
        assert te.stats["prefix_cached_tokens"] == je.stats["prefix_cached_tokens"]
    te.pool.check()
    assert te.pool.pages_in_use == (te.prefix.pages_cached() if prefix else 0)


def test_optimistic_preemption_identical_to_jax(models):
    """18 pages cannot hold the three requests' growth: both engines preempt
    the youngest request and still emit the same tokens."""
    ecfg = dict(BASE, num_pages=18, policy="optimistic")
    cfg, params, je, te, outs = run_both(models, "granite-8b", {}, ecfg, 24)
    for prompt, want, got in outs[0]:
        assert_same_or_tie(cfg, params, prompt, want, got)
    assert te.stats["evictions"] == je.stats["evictions"] > 0
    assert te.stats["prefill_chunks"] == je.stats["prefill_chunks"]
    te.pool.check()
    assert te.pool.pages_in_use == 0


# ------------------------------------------------------------ within the port
def _port_engine(models, name="granite-8b", **kw):
    _, _, tcfg, tparams = models(name)
    return tcfg, ServeEngine(tcfg, tparams, TRT, EngineConfig(**dict(BASE, **kw)),
                             device="cpu")


def test_batched_equals_alone_with_temperature(models):
    tcfg, eng = _port_engine(models, temperature=0.8, seed=3)
    prompts = prompts_for(tcfg, seed=4)
    rids = [eng.submit(p, 10) for p in prompts]
    batched = eng.run()
    for p, rid in zip(prompts, rids):
        _, alone_eng = _port_engine(models, temperature=0.8, seed=3)
        # the same rid, so the same (seed, rid, step) streams
        for _ in range(rid):
            alone_eng.submit(p[:4], 1)
        a = alone_eng.submit(p, 10)
        np.testing.assert_array_equal(alone_eng.run()[a], batched[rid])
    greedy = _port_engine(models)[1]
    g = [greedy.submit(p, 10) for p in prompts]
    assert any(not np.array_equal(greedy.run()[x], batched[r]) for x, r in zip(g, rids))


def test_cache_on_equals_cold(models):
    tcfg, cold = _port_engine(models)
    prompts = prompts_for(tcfg, seed=6)
    shared = prompts[1][:40]
    prompts = [np.concatenate([shared, p]) for p in (prompts[0], prompts[2])]
    rids = [cold.submit(p, 6) for p in prompts]
    want = cold.run()
    _, warm = _port_engine(models, prefix_cache=True)
    warm.submit(shared, 2)
    warm.run()
    wr = [warm.submit(p, 6) for p in prompts]
    got = warm.run()
    assert warm.stats["prefix_hits"] >= 2
    for a, b in zip(rids, wr):
        np.testing.assert_array_equal(got[b], want[a])
    warm.pool.check()


def test_on_token_streams_and_cancel(models):
    tcfg, eng = _port_engine(models)
    prompts = prompts_for(tcfg, seed=8)
    seen, done = {}, {}

    def cb(rid, toks, reason):
        seen.setdefault(rid, []).extend(toks)
        if reason:
            done[rid] = reason
        if rid == 1 and len(seen[rid]) >= 3 and rid not in done:
            eng.cancel(rid)

    rids = [eng.submit(p, 8, on_token=cb) for p in prompts]
    out = eng.run()
    assert done == {0: "complete", 1: "cancelled", 2: "complete"}
    assert 1 not in out and seen[0] == out[0].tolist()
    assert eng.stats["cancelled"] == 1
    eng.pool.check()
    assert eng.pool.pages_in_use == 0 and rids == [0, 1, 2]


# -------------------------------------------------------------- host modules
def test_pool_alloc_fork_cow_and_check():
    pool = PagePool(num_pages=9, page_size=4)
    a = pool.alloc(6)
    b = pool.fork(a)
    pool.append(b, 1)                        # shared partial tail -> COW
    (src, dst), = pool.drain_copies()
    assert src == pool.seq_pages(a)[-1] and dst == pool.seq_pages(b)[-1]
    pool.check()
    with pytest.raises(PoolExhausted):
        pool.alloc(100)
    pool.free(a), pool.free(b)
    pool.check()
    assert pool.pages_in_use == 0


def test_radix_split_and_lru_eviction_of_idle_leaves():
    pool = PagePool(num_pages=17, page_size=2)
    cache = PrefixCache(pool)
    prompts = [[1, 2, 10, 11], [1, 2, 20, 21], [1, 2, 30, 31]]
    for p in prompts:
        sid = pool.alloc(4)
        cache.insert(p, pool.seq_pages(sid))
        pool.free(sid)
    cache.check(), pool.check()              # [1, 2] split into its own node
    assert cache.pages_cached() == 4
    cache.match(prompts[0], max_tokens=4)
    cache.match(prompts[1], max_tokens=4)
    n, pages = cache.match(prompts[1], max_tokens=4)
    pinned = pool.adopt(pages, n)
    cache.evict_until(1)                     # the LRU idle leaf goes
    assert cache.match(prompts[2], max_tokens=4)[0] == 2
    assert cache.match(prompts[0], max_tokens=4)[0] == 4
    assert cache.evict_until(10) == 1        # the adopted path stays pinned
    pool.free(pinned)
    pool.check(), cache.check()


# ---------------------------------------------------------------- rejections
REJECT = {
    "paged=False": lambda m: ServeEngine(*m("granite-8b")[2:], TRT,
                                         EngineConfig(**BASE), paged=False,
                                         device="cpu"),
    "whole-prompt admission": lambda m: ServeEngine(
        *m("granite-8b")[2:], TRT, EngineConfig(**dict(BASE, prefill_chunk=0)),
        device="cpu"),
    "spec_tokens": lambda m: ServeEngine(
        *m("granite-8b")[2:], TRT, EngineConfig(**dict(BASE, spec_tokens=2)),
        device="cpu"),
    "kv_dtype int8": lambda m: ServeEngine(
        *m("granite-8b")[2:], TRT, EngineConfig(**dict(BASE, kv_dtype="int8")),
        device="cpu"),
    "kv_dtype fp8": lambda m: ServeEngine(
        *m("granite-8b")[2:], TRT, EngineConfig(**dict(BASE, kv_dtype="fp8")),
        device="cpu"),
    "dense family": lambda m: ServeEngine(
        t_get_reduced("falcon-mamba-7b"), m("granite-8b")[3], TRT,
        EngineConfig(**BASE), device="cpu"),
    "modality prefix": lambda m: ServeEngine(
        t_get_reduced("phi-3-vision-4.2b"), m("granite-8b")[3], TRT,
        EngineConfig(**BASE), device="cpu"),
    "replicated": lambda m: ReplicatedServeEngine(*m("granite-8b")[2:], TRT),
}


@pytest.mark.parametrize("mode", sorted(REJECT))
def test_modes_left_out_raise_not_implemented(models, mode):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        REJECT[mode](models)


@pytest.mark.parametrize("argv", [
    ["--paged", "--prefill-chunk", "8", "--kv-dtype", "int8"],
    ["--paged", "--prefill-chunk", "8", "--spec", "2"],
    ["--paged", "--prefill-chunk", "8", "--mesh", "2x2"],
    ["--paged", "--prefill-chunk", "8", "--trace", "poisson"],
    ["--paged"],
    ["--prefill-chunk", "8"],
])
def test_launcher_rejects_later_slices(argv, capsys):
    with pytest.raises(SystemExit) as e:
        launch_serve.main(argv + ["--device", "cpu"])
    assert e.value.code == 2
    assert "ROADMAP" in capsys.readouterr().err


def test_engine_defaults_to_the_card(models):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, _, tcfg, tparams = models("granite-8b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(tcfg, tparams, TRT, EngineConfig(**BASE))


def test_launcher_serves_reduced_granite_on_cpu(capsys):
    launch_serve.main(["--arch", "granite-8b", "--paged", "--prefill-chunk", "8",
                       "--device", "cpu", "--requests", "3", "--new-tokens", "4",
                       "--prefix-cache", "--shared-prefix", "16"])
    out = capsys.readouterr().out
    assert "granite-8b-reduced" in out and "prefix-cache: hits" in out
