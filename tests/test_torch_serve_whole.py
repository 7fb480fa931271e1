"""The port's whole-prompt prefill and dense-cache generation against the JAX
package, on the CPU in f32 (plain attention), at reduced sizes.

* ``lm.prefill(full_cache=True)``: logits and every layer's collected k/v and
  positions against JAX's (2e-5); ``write_prefill_to_pool``'s pages against
  JAX's eager scatter of the same caches, bitwise (int8: codes and scales
  against JAX's eager codec).
* Whole-prompt admission (``prefill_chunk=0``): greedy tokens against the JAX
  engine's on reduced granite-8b (MQA, and GQA with 2 kv heads), gemma3-1b
  (window 64), granite-34b and survey-demo-100m,
  ``prefill_bucket`` 0 and 8, and over an int8 pool (a first difference only
  under ``QUANT_MARGIN``); a bucket padded past the window, and one padded
  past the block table's end (its last real page must stay intact).
* Dense generation: the teacher-forced ``forward`` argmax at gemma3-1b
  prompts of 60, 64, 70 and 131 tokens (70 and 131 run past the 64 window at
  a length that is not a multiple of it, where the JAX ring cache is wrong:
  ROADMAP queue 3), JAX's ``generate`` where its ring is exact, and the port's
  paged ``generate``.
* ``ServeEngine(paged=False)`` batches same-shape requests; the launcher
  serves whole-prompt and dense on the CPU.

The JAX engines and prefills compile once per config and shape (module
fixtures and JAX's own caches); prompts keep to a few lengths.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models import Runtime, init_params
from repro.models import prefill as jprefill
from repro.models.stack import build_segments, init_stack_pool
from repro.models.stack import layer_specs as jlayer_specs
from repro.models.stack import write_prefill_to_pool as jwrite_prefill_to_pool
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServeEngine as JServeEngine
from repro.train.serve import generate as jgenerate
from repro_torch.checkpoint import params_from_jax
from repro_torch.configs import get_reduced as t_get_reduced
from repro_torch.launch import serve as launch_serve
from repro_torch.models import Runtime as TRuntime
from repro_torch.models import forward as tforward
from repro_torch.models import init_paged_state
from repro_torch.models import prefill as tprefill
from repro_torch.models.stack import write_prefill_to_pool
from repro_torch.serve import EngineConfig, ServeEngine
from repro_torch.train.serve import generate
from test_torch_serve_engine import assert_same_or_quantized_tie, assert_same_or_tie

# pytest-xdist runs several workers on one machine: give torch this worker's share
# of the cores (oversubscribed, the torch side runs many times slower)
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

RT = Runtime(dtype=jnp.float32, chunk_q=32)
TRT = TRuntime(dtype=torch.float32)
TOL = 2e-5                       # f32 on both sides, sums in another order
WHOLE = dict(max_slots=2, page_size=8, num_pages=33, max_len=128, inner_steps=4)
LENGTHS = (17, 21, 24)           # bucket 8 pads all three to one JAX prefill program
NEW = 6


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


def prompt(cfg, n, seed=0):
    return np.random.RandomState(seed + n).randint(0, cfg.vocab_size, (n,)).astype(np.int32)


def jax_layers(caches, cfg, specs):
    """JAX's segment-layout caches as one numpy ``{k, v, pos}`` per layer."""
    out = []
    for seg, c in zip(build_segments(cfg, specs), caches):
        for r in range(seg.repeats):
            for j in range(len(seg.unit_specs)):
                out.append({k: np.asarray(v[r]) for k, v in c[f"p{j}"].items()})
    return out


# ------------------------------------------------------ prefill and scatter
PREFILL = [("granite-8b", {}, 21), ("granite-8b", {"n_kv_heads": 2}, 40),
           ("gemma3-1b", {}, 70)]


@pytest.mark.parametrize("name,over,S", PREFILL, ids=[f"{n}{o}-S{s}" for n, o, s in PREFILL])
def test_prefill_logits_and_caches_match_jax(models, name, over, S):
    """lm.prefill over a prompt padded to a bucket (gather at its true last
    position) with full-horizon caches: logits and each layer's collected
    k, v (2e-5) and positions (exactly) against JAX's."""
    cfg, params, tcfg, tparams = models(name, **over)
    tokens = np.stack([prompt(cfg, S), prompt(cfg, S, seed=1)])
    horizon, gather = S + 8, S - 3
    jl, js = jax.jit(lambda p, b: jprefill(cfg, p, b, RT, max_len=horizon,
                                           gather_pos=gather, full_cache=True))(
        params, {"tokens": jnp.asarray(tokens)})
    tl, ts = tprefill(tcfg, tparams, {"tokens": torch.from_numpy(tokens)}, TRT,
                      max_len=horizon, gather_pos=gather, full_cache=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    assert ts["t"] == int(js["t"]) == S
    want = jax_layers(js["caches"], cfg, jlayer_specs(cfg, seq_len=S))
    assert len(ts["caches"]) == len(want) == tcfg.n_layers
    for i, (got, ref) in enumerate(zip(ts["caches"], want)):
        assert got["k"].shape == ref["k"].shape == (2, horizon, tcfg.n_kv_heads, tcfg.head_dim)
        np.testing.assert_array_equal(got["pos"].numpy(), ref["pos"], err_msg=f"layer {i}")
        for k in "kv":
            np.testing.assert_allclose(got[k].numpy(), ref[k], atol=TOL, rtol=TOL,
                                       err_msg=f"layer {i} {k}")


@pytest.fixture(scope="module")
def granite_prefill_40(models):
    """JAX's collected caches of one 40-token granite-8b prompt (rings of 48),
    compiled once for both pool dtypes."""
    cfg, params, _, _ = models("granite-8b")
    _, js = jax.jit(lambda p, b: jprefill(cfg, p, b, RT, max_len=48, full_cache=True))(
        params, {"tokens": jnp.asarray(prompt(cfg, 40)[None])})
    return js["caches"]


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_write_prefill_to_pool_pages_match_jax(models, granite_prefill_40, kv_dtype):
    """The same collected caches scattered by JAX (eagerly) and by the port:
    every page bitwise, f32 rows or int8 codes and scales. The table covers
    4 pages of 8 while the prefill holds 40 positions in rings of 48: the 8
    past the table and the 8 invalid rows land on the null page 0 (not
    compared)."""
    cfg, params, tcfg, tparams = models("granite-8b")
    S, page = 40, 8
    layers = jax_layers(granite_prefill_40, cfg, jlayer_specs(cfg, seq_len=S))
    table = np.array([7, 3, 9, 1], np.int32)
    jrt = RT.replace(kv_dtype=kv_dtype)
    specs = jlayer_specs(cfg, seq_len=S + 8)
    jpools = jwrite_prefill_to_pool(init_stack_pool(cfg, jrt, specs, 16, page),
                                    granite_prefill_40, jnp.asarray(table), page)
    jpools = jax_layers(jpools, cfg, specs)
    st = init_paged_state(tcfg, 1, TRT.replace(kv_dtype=kv_dtype), num_pages=16,
                          page_size=page, max_len=S + 8, device="cpu")
    tcaches = [{k: torch.tensor(v) for k, v in c.items()} for c in layers]
    write_prefill_to_pool(st["caches"], tcaches, torch.from_numpy(table), page)
    names = {"k": "kp", "v": "vp", "ksc": "ksc", "vsc": "vsc"}
    assert set(st["caches"]) == ({"k", "v", "ksc", "vsc"} if kv_dtype else {"k", "v"})
    for key, pool in st["caches"].items():
        for i in range(tcfg.n_layers):
            got = pool[i, 1:].contiguous()
            ref = jpools[i][names[key]][1:]
            if got.dtype == torch.int8:
                got = got.view(torch.uint8)
                ref = ref.view(np.uint8)
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"{key} layer {i}")
    assert st["caches"]["k"][:, table].abs().sum() > 0


# ------------------------------------------------- whole-prompt admission
@pytest.fixture(scope="module")
def jax_engines(models):
    """JAX whole-prompt engine runs, one per (config, kv dtype), at bucket 8:
    one JAX prefill program for the three prompts. JAX's bucketed prefill is
    exact (tests/test_serve_engine.py:236), so this run is the reference of
    the port's engine at buckets 0 and 8 alike."""
    cache = {}

    def get(name, over, kv_dtype="bf16"):
        key = (name, tuple(sorted(over.items())), kv_dtype)
        if key not in cache:
            cfg = models(name, **over)[0]
            je = JServeEngine(cfg, models(name, **over)[1], RT, JEngineConfig(
                **WHOLE, prefill_bucket=8, kv_dtype=kv_dtype))
            prompts = [prompt(cfg, n) for n in LENGTHS]
            rids = [je.submit(p, NEW) for p in prompts]
            out = je.run()
            cache[key] = (prompts, [out[r] for r in rids], je.stats)
        return cache[key]

    return get


# granite-34b (48 query heads over one kv head, 4 over 1 reduced) and
# survey-demo-100m: served, and held to JAX's engine here
WHOLE_IDENTITY = [(n, o, b) for n, o in (("granite-8b", {}), ("granite-8b", {"n_kv_heads": 2}),
                                         ("gemma3-1b", {}), ("granite-34b", {}),
                                         ("survey-demo-100m", {})) for b in (0, 8)]


@pytest.mark.parametrize("name,over,bucket", WHOLE_IDENTITY,
                         ids=[f"{n}{o}-bucket{b}" for n, o, b in WHOLE_IDENTITY])
def test_whole_prompt_tokens_match_jax(models, jax_engines, name, over, bucket):
    cfg, params, tcfg, tparams = models(name, **over)
    prompts, want, jstats = jax_engines(name, over)
    te = ServeEngine(tcfg, tparams, TRT, EngineConfig(**WHOLE, prefill_bucket=bucket),
                     device="cpu")
    rids = [te.submit(p, NEW) for p in prompts]
    out = te.run()
    for p, w, r in zip(prompts, want, rids):
        assert out[r].shape == (NEW,)
        assert_same_or_tie(cfg, params, p, w, out[r])
    assert "prefill_chunks" not in te.stats and set(te.stats["ttft_s"]) == set(rids)
    assert te.stats["kv_bytes"] == jstats["kv_bytes"]
    te.pool.check()
    assert te.pool.pages_in_use == 0


def test_whole_prompt_int8_pool_tokens_match_jax(models, jax_engines):
    """Over an int8 pool the scatter quantizes each row once; the two
    engines' codecs differ by XLA's reciprocal (ROADMAP queue 3), so a first
    difference is allowed only under QUANT_MARGIN."""
    cfg, params, tcfg, tparams = models("granite-8b")
    prompts, want, _ = jax_engines("granite-8b", {}, "int8")
    te = ServeEngine(tcfg, tparams, TRT,
                     EngineConfig(**WHOLE, prefill_bucket=8, kv_dtype="int8"), device="cpu")
    rids = [te.submit(p, NEW) for p in prompts]
    out = te.run()
    assert te._dev["caches"]["k"].dtype == torch.int8
    for p, w, r in zip(prompts, want, rids):
        assert_same_or_quantized_tie(cfg, params, p, w, out[r], "int8")


def test_bucket_past_the_window_is_exact(models):
    """tests/test_serve_engine.py:269's case: a 66-token prompt padded to 80
    past gemma3-1b's 64 window. Full caches keep every real position: the
    tokens equal the port's dense generate and the teacher-forced argmax
    (JAX's dense generate, that test's reference, is not exact here: its
    ring is wrong past the window at 66 tokens)."""
    _, _, tcfg, tparams = models("gemma3-1b")
    assert tcfg.sliding_window == 64
    p = prompt(tcfg, 66, seed=13)
    te = ServeEngine(tcfg, tparams, TRT, EngineConfig(
        max_slots=1, page_size=16, num_pages=13, max_len=96, inner_steps=3,
        prefill_bucket=16), device="cpu")
    rid = te.submit(p, 4)
    got = te.run()[rid]
    dense, _ = generate(tcfg, tparams, {"tokens": p[None]}, TRT, 4)
    np.testing.assert_array_equal(got, dense[0].numpy())
    np.testing.assert_array_equal(
        got, teacher_forced_argmax(tcfg, tparams, p[None], dense)[0].numpy())


def test_bucket_past_the_table_keeps_the_last_page(models):
    """A 40-token prompt padded to 64 with a table of 6 pages of 8 (48
    positions): positions 48..63 must land on the null page, not on the last
    real page (a clip would). The pages hold the unpadded prefill's rows at
    every real position, and the tokens equal the dense generate's."""
    cfg, params, tcfg, tparams = models("granite-8b")
    p = prompt(cfg, 40, seed=5)
    ecfg = EngineConfig(max_slots=1, page_size=8, num_pages=8, max_len=48, inner_steps=4,
                        prefill_bucket=32)
    te = ServeEngine(tcfg, tparams, TRT, ecfg, device="cpu")
    rid = te.submit(p, 8)
    te._admit_free_slots()                          # the whole-prompt admission alone
    pages = te.pool.seq_pages(te._slots[0].sid)
    assert len(pages) == 6
    _, ref = tprefill(tcfg, tparams, {"tokens": torch.from_numpy(p[None])}, TRT)
    kp = te._dev["caches"]["k"]
    for i, c in enumerate(ref["caches"]):
        rows = kp[i, torch.tensor(pages)].reshape(48, tcfg.n_kv_heads, tcfg.head_dim)
        torch.testing.assert_close(rows[:40], c["k"][0], atol=TOL, rtol=TOL)
    while te.busy:
        te.step()
    out = te.run_finalize()
    dense, _ = generate(tcfg, tparams, {"tokens": p[None]}, TRT, 8)
    np.testing.assert_array_equal(out[rid], dense[0].numpy())
    te.pool.check()


# ----------------------------------------------------------- dense generate
def teacher_forced_argmax(tcfg, tparams, tokens, out):
    """The port's full forward over prompt + generated tokens: its argmax at
    each generated position."""
    seq = torch.cat([torch.as_tensor(tokens), out[:, :-1]], dim=1)
    logits, _ = tforward(tcfg, tparams, {"tokens": seq}, TRT)
    S = tokens.shape[1]
    return logits[:, S - 1:, : tcfg.vocab_size].argmax(-1).to(torch.int32)


@pytest.mark.parametrize("S", [60, 64, 70, 131])
def test_dense_generate_matches_teacher_forced_argmax(models, S):
    """gemma3-1b (window 64): at 70 and 131 tokens the prompt runs past the
    window at a length that is not a multiple of it. The port's ring keeps
    position p at row p % 64, so the first decode write replaces the oldest
    row; greedy tokens equal the teacher-forced argmax at every step."""
    _, _, tcfg, tparams = models("gemma3-1b")
    tokens = np.stack([prompt(tcfg, S, seed=2), prompt(tcfg, S, seed=3)])
    out, state = generate(tcfg, tparams, {"tokens": tokens}, TRT, NEW)
    assert out.shape == (2, NEW) and state["t"] == S + NEW - 1
    np.testing.assert_array_equal(out.numpy(),
                                  teacher_forced_argmax(tcfg, tparams, tokens, out).numpy())


def test_dense_generate_matches_jax_where_its_ring_is_exact(models):
    """A prompt as long as gemma3-1b's 64 window (within it, and a multiple
    of it): JAX's ring is exact there, and its greedy tokens equal the
    port's."""
    S = 64
    cfg, params, tcfg, tparams = models("gemma3-1b")
    tokens = np.stack([prompt(cfg, S, seed=2), prompt(cfg, S, seed=3)])
    want, _ = jgenerate(cfg, params, {"tokens": jnp.asarray(tokens)}, RT, NEW)
    got, _ = generate(tcfg, tparams, {"tokens": tokens}, TRT, NEW)
    for b in range(2):
        assert_same_or_tie(cfg, params, tokens[b], np.asarray(want[b]), got[b].numpy())


@pytest.mark.parametrize("name", ["granite-8b", "gemma3-1b"])
def test_paged_generate_matches_dense(models, name):
    """tests/test_serve_engine.py:93: the engine (whole-prompt admission)
    and the dense rings give the same greedy tokens."""
    _, _, tcfg, tparams = models(name)
    tokens = np.stack([prompt(tcfg, 10, seed=3), prompt(tcfg, 10, seed=4)])
    dense, _ = generate(tcfg, tparams, {"tokens": tokens}, TRT, NEW)
    paged, stats = generate(tcfg, tparams, {"tokens": torch.from_numpy(tokens)}, TRT, NEW,
                            paged=True)
    np.testing.assert_array_equal(paged.numpy(), dense.numpy())
    assert set(stats["ttft_s"]) == {0, 1} and set(stats["kv_bytes"]) == {0, 1}


# ---------------------------------------------------------- dense fallback
def test_dense_engine_batches_same_shape_requests(models):
    """paged=False: a tick runs the head request and the queued requests of
    its (prompt length, max_new) shape, up to max_slots, as one batch; each
    request's tokens equal its dense generation alone, greedy and (its own
    stream) at temperature 0.8."""
    _, _, tcfg, tparams = models("granite-8b")
    prompts = [prompt(tcfg, 12, seed=s) for s in (1, 2, 3)] + [prompt(tcfg, 9)]
    for temperature in (0.0, 0.8):
        ecfg = EngineConfig(max_slots=2, temperature=temperature, seed=5)
        eng = ServeEngine(tcfg, tparams, TRT, ecfg, paged=False, device="cpu")
        rids = [eng.submit(p, 5) for p in (prompts[0], prompts[3], prompts[1], prompts[2])]
        first = eng.step()
        assert first["finished"] == [rids[0], rids[2]] and first["decoded"] == 10
        while eng.busy:
            eng.step()
        out = eng.run_finalize()
        assert sorted(out) == sorted(rids)
        assert eng.stats["kv_bytes"][rids[1]] > 0 and eng.kv_pool_bytes_per_device() == 0
        for rid, p in zip(rids, (prompts[0], prompts[3], prompts[1], prompts[2])):
            alone = ServeEngine(tcfg, tparams, TRT, ecfg, paged=False, device="cpu")
            for _ in range(rid):                # the same rid: the same stream
                alone.submit(p[:4], 1)
            a = alone.submit(p, 5)
            np.testing.assert_array_equal(alone.run()[a], out[rid])
            if temperature == 0.0:
                want, _ = generate(tcfg, tparams, {"tokens": p[None]}, TRT, 5)
                np.testing.assert_array_equal(out[rid], want[0].numpy())


# ---------------------------------------------------------------- launcher
@pytest.mark.parametrize("argv,expect", [
    (["--paged"], "admission by whole prompt"),
    (["--paged", "--kv-dtype", "int8"], "kv-pool: dtype=int8"),
    (["--batch", "2"], "dense: 8 tokens"),
])
def test_launcher_serves_whole_prompt_and_dense_on_cpu(argv, expect, capsys):
    launch_serve.main(["--arch", "granite-8b", "--device", "cpu", "--requests", "3",
                       "--new-tokens", "4", "--temperature", "0"] + argv)
    out = capsys.readouterr().out
    assert "granite-8b-reduced" in out and expect in out, out
