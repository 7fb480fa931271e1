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
* Quantized pools (int8, fp8): greedy tokens against the JAX engine at the
  same kv_dtype, with a tie bound for the codec's jitted-vs-eager rounding
  (``QUANT_MARGIN``); batched == alone and cache-on == cold bitwise; the
  teacher-forced logit error against the native pool within JAX's limits;
  the pool's codes and scales bitwise equal to ``kv_quantize`` of the rows
  written, carried by adopted pages.
* Host modules: the port's pool, scheduler and radix cache invariants.
* Rejections: each mode the port leaves out raises NotImplementedError.
  Whole-prompt admission and the dense fallback are served: their tests are
  in tests/test_torch_serve_whole.py; speculative decoding's, with the
  configurations it refuses, in tests/test_torch_serve_spec.py.
"""
import os

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
from repro_torch.kernels.paged_attention import quant
from repro_torch.models import attention as t_attention
from repro_torch.models import decode_step_paged, init_paged_state, prefill_chunk_paged
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

# pytest-xdist runs several workers on one machine: give torch this worker's share
# of the cores (oversubscribed, the torch side runs many times slower)
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

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
            tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                      device="cpu")
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


def jax_batch(prompt, want, i, frontend_embeds=None):
    """JAX's teacher-forced batch: the prompt and the first ``i`` tokens of
    ``want``, behind a vision request's image."""
    batch = {"tokens": jnp.asarray(np.concatenate([prompt, want[:i]])[None])}
    if frontend_embeds is not None:
        batch["frontend_embeds"] = jnp.asarray(np.asarray(frontend_embeds)[None])
    return batch


def assert_same_or_tie(cfg, params, prompt, want, got, frontend_embeds=None):
    """Equal tokens, or a first difference at an f32 tie of the JAX logits
    (over the request's image too, for a vision config)."""
    if np.array_equal(want, got):
        return
    i = int(np.nonzero(want != got)[0][0])
    logits, _ = forward(cfg, params, jax_batch(prompt, want, i, frontend_embeds), RT)
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


# ------------------------------------------------------- quantized KV pools
# JAX's limits on a quantized pool's teacher-forced logit error against the
# native pool, as a share of max|logit| (tests/test_serve_engine.py:442)
QUANT_REL_TOL = {"int8": 0.04, "fp8": 0.15}
# The JAX engine jits its KV writes, and XLA computes absmax / cmax as a
# product with the reciprocal: its scales sit an ulp off the port's (eager
# IEEE division) in 4.52% (int8) / 58.7% (fp8) of rows, and 1.16e-4 / 1.16e-3
# of its codes one step off (JAX 0.9.0 on the CPU, 4096 x 8 rows of 128
# bf16). So the two engines' pools differ in a few codes, and their greedy
# tokens may part where the choice is close. Each engine's quantized logits
# lie within QUANT_REL_TOL * max|logit| of the native ones (JAX's limit,
# which test_quantized_pool_logit_error_within_jax_limits holds the port
# to), so two argmaxes can differ only where the dense f32 logits' top-2
# margin is below twice that: the bound a first difference must meet.
QUANT_MARGIN = {k: 2 * v for k, v in QUANT_REL_TOL.items()}
QUANT_IDENTITY = [(n, o, p, kv) for kv in ("int8", "fp8")
                  for n, o in (("granite-8b", {}), ("gemma3-1b", {}))
                  for p in (False, True)]


def assert_same_or_quantized_tie(cfg, params, prompt, want, got, kv_dtype,
                                 frontend_embeds=None):
    """Equal tokens, or a first difference where the JAX dense logits'
    top-2 margin is below ``QUANT_MARGIN[kv_dtype] * max|logit|``."""
    if np.array_equal(want, got):
        return
    i = int(np.nonzero(want != got)[0][0])
    logits, _ = forward(cfg, params, jax_batch(prompt, want, i, frontend_embeds), RT)
    last = np.asarray(logits[0, -1, : cfg.vocab_size])
    top2 = np.sort(last)[-2:]
    margin = float(top2[1] - top2[0]) / float(np.abs(last).max())
    print(f"{kv_dtype}: first divergence at token {i}: JAX top-2 margin "
          f"{margin:.3e} of max|logit|")
    assert margin < QUANT_MARGIN[kv_dtype], (i, margin, want, got)


@pytest.mark.parametrize("name,over,prefix,kv_dtype", QUANT_IDENTITY,
                         ids=[f"{n}-prefix{p}-{kv}" for n, o, p, kv in QUANT_IDENTITY])
def test_quantized_greedy_tokens_match_jax(models, name, over, prefix, kv_dtype):
    """The port's engine and the JAX engine at the same int8 / fp8 kv_dtype:
    reduced granite-8b and gemma3-1b (window), chunked prefill, the prefix
    cache off and on (a second run adopts cached prompts)."""
    ecfg = dict(BASE, prefix_cache=prefix, kv_dtype=kv_dtype)
    cfg, params, je, te, outs = run_both(models, name, over, ecfg, 8,
                                         runs=2 if prefix else 1)
    same = 0
    for run in outs:
        for prompt, want, got in run:
            assert got.shape == (8,)
            assert_same_or_quantized_tie(cfg, params, prompt, want, got, kv_dtype)
            same += int(np.array_equal(want, got))
    print(f"{name} {kv_dtype} prefix={prefix}: {same} of {sum(map(len, outs))} "
          "requests token-identical")
    assert set(te._dev["caches"]) == {"k", "v", "ksc", "vsc"}
    assert te._dev["caches"]["k"].dtype == quant.kv_storage_dtype(kv_dtype, None)
    assert te.stats["prefill_chunks"] == je.stats["prefill_chunks"]
    if prefix:
        assert te.stats["prefix_hits"] == je.stats["prefix_hits"] > 0
    te.pool.check()


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_pool_batched_equals_alone_and_cache_on_equals_cold(models, kv_dtype):
    """Each row is quantized once, from its own values, so the port's
    quantized engine gives the same tokens batched and alone (temperature
    0.8, JAX's test_serve_engine.py:361) and with the prefix cache on and
    cold, bitwise."""
    tcfg, eng = _port_engine(models, temperature=0.8, seed=3, kv_dtype=kv_dtype)
    prompts = prompts_for(tcfg, seed=4)
    rids = [eng.submit(p, 10) for p in prompts]
    batched = eng.run()
    for p, rid in zip(prompts, rids):
        _, alone_eng = _port_engine(models, temperature=0.8, seed=3, kv_dtype=kv_dtype)
        for _ in range(rid):
            alone_eng.submit(p[:4], 1)
        a = alone_eng.submit(p, 10)
        np.testing.assert_array_equal(alone_eng.run()[a], batched[rid])

    shared = prompts[1][:40]
    cached = [np.concatenate([shared, p]) for p in (prompts[0], prompts[2])]
    _, cold = _port_engine(models, kv_dtype=kv_dtype)
    crids = [cold.submit(p, 6) for p in cached]
    want = cold.run()
    _, warm = _port_engine(models, prefix_cache=True, kv_dtype=kv_dtype)
    warm.submit(shared, 2)
    warm.run()
    wr = [warm.submit(p, 6) for p in cached]
    got = warm.run()
    assert warm.stats["prefix_hits"] >= 2
    for a, b in zip(crids, wr):
        np.testing.assert_array_equal(got[b], want[a])
    warm.pool.check()


def _teacher_forced_logits(cfg, params, prompt, kv_dtype, steps, teacher=None):
    """The port's paged path alone: the prompt in chunks of 8, then decode
    steps fed ``teacher`` (greedy when None). Returns (logits, tokens)."""
    rt = TRT.replace(kv_dtype=kv_dtype)
    page, max_len = 8, 64
    st = init_paged_state(cfg, 1, rt, num_pages=max_len // page + 1, page_size=page,
                          max_len=max_len, device="cpu")
    st["tables"][0] = torch.arange(1, max_len // page + 1)
    logs = []
    for s in range(0, len(prompt), 8):
        chunk = np.zeros(8, np.int32)
        n = min(8, len(prompt) - s)
        chunk[:n] = prompt[s:s + n]
        lg = prefill_chunk_paged(cfg, params, st["caches"], st["tables"][0],
                                 torch.from_numpy(chunk), s, n, rt, max_len)
    logs.append(lg)
    st["lengths"][0] = len(prompt)
    toks = []
    for i in range(steps):
        tok = int(logs[-1].argmax()) if teacher is None else teacher[i]
        toks.append(tok)
        logs.append(decode_step_paged(cfg, params, st, torch.tensor([tok], dtype=torch.int32),
                                      rt, max_len)[0])
    return logs, toks


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("name", ["granite-8b", "gemma3-1b"])
def test_quantized_pool_logit_error_within_jax_limits(models, name, kv_dtype):
    """Teacher-forced over a quantized pool, the port's logits stay within
    JAX's limits of the native (f32) pool's: int8 0.04, fp8 0.15 of
    max|logit| (tests/test_serve_engine.py:442). The chunked prefill reads
    the quantized pool too, so every step may drift, but none is exact."""
    _, _, tcfg, tparams = models(name)
    prompt = np.random.RandomState(13).randint(0, tcfg.vocab_size, (11,)).astype(np.int32)
    ref, toks = _teacher_forced_logits(tcfg, tparams, prompt, "", steps=5)
    got, _ = _teacher_forced_logits(tcfg, tparams, prompt, kv_dtype, steps=5, teacher=toks)
    scale = max(float(lg.abs().max()) for lg in ref)
    err = max(float((a - b).abs().max()) for a, b in zip(ref, got))
    print(f"{name} {kv_dtype}: max logit error {err / scale:.3e} of max|logit|")
    assert 0.0 < err <= QUANT_REL_TOL[kv_dtype] * scale, (err, scale)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_pool_codes_and_scales_follow_pages(models, kv_dtype, monkeypatch):
    """The pools hold, at every slot written, ``kv_quantize`` of the K/V row
    last written there, bitwise, codes and scale at the same page id; pages
    freed and written again carry the new writer's scales; pages adopted
    from the prefix cache keep their codes and scales untouched."""
    written = {}
    real = t_attention._write_rows

    def spy(kp, vp, ksc, vsc, pid, slot, k_new, v_new):
        for idx in zip(pid.reshape(-1).tolist(), slot.reshape(-1).tolist(),
                       range(pid.numel())):
            p, s, j = idx
            if p:                      # the null page's writes are garbage
                written[(kp.data_ptr(), p, s)] = (
                    k_new.reshape(-1, *k_new.shape[-2:])[j].clone(),
                    v_new.reshape(-1, *v_new.shape[-2:])[j].clone())
        return real(kp, vp, ksc, vsc, pid, slot, k_new, v_new)

    monkeypatch.setattr(t_attention, "_write_rows", spy)
    tcfg, eng = _port_engine(models, prefix_cache=True, kv_dtype=kv_dtype)
    prompts = prompts_for(tcfg, seed=9)
    for p in prompts:
        eng.submit(p, 6)
    eng.run()
    caches = eng._dev["caches"]
    n, pages = eng.prefix.match(prompts[1], max_tokens=len(prompts[1]) - 1)
    assert n > 0
    snap = {k: v[:, pages].clone() for k, v in caches.items()}
    for p in prompts + [prompts_for(tcfg, seed=10)[2]]:   # adopt; reuse freed pages
        eng.submit(p, 6)
    eng.run()
    assert eng.stats["prefix_hits"] >= 3
    for k, v in snap.items():
        assert torch.equal(caches[k][:, pages], v), k
    layer_of = {caches["k"][i].data_ptr(): i for i in range(caches["k"].shape[0])}
    store = caches["k"].dtype
    assert len(written) > 0
    for (ptr, p, s), (k_row, v_row) in written.items():
        i = layer_of[ptr]
        for pool, scales, row in (("k", "ksc", k_row), ("v", "vsc", v_row)):
            codes, sc = quant.kv_quantize(row, store)
            assert torch.equal(caches[pool][i, p, s].view(torch.uint8),
                               codes.view(torch.uint8)), (pool, i, p, s)
            assert torch.equal(caches[scales][i, p, s], sc), (scales, i, p, s)
    eng.pool.check()


def test_launcher_serves_reduced_granite_with_an_int8_pool(capsys):
    launch_serve.main(["--arch", "granite-8b", "--paged", "--prefill-chunk", "8",
                       "--device", "cpu", "--requests", "3", "--new-tokens", "4",
                       "--kv-dtype", "int8"])
    out = capsys.readouterr().out
    assert "granite-8b-reduced" in out and "kv-pool: dtype=int8" in out
    assert "capacity_factor_vs_bf16=1.88x" in out


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
    "replicated": lambda m: ReplicatedServeEngine(*m("granite-8b")[2:], TRT),
}


@pytest.mark.parametrize("mode", sorted(REJECT))
def test_modes_left_out_raise_not_implemented(models, mode):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        REJECT[mode](models)


@pytest.mark.parametrize("argv", [
    ["--paged", "--prefill-chunk", "8", "--mesh", "2x2"],
    ["--paged", "--prefill-chunk", "8", "--trace", "poisson"],
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
