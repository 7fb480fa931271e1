"""The port's vision-prefix family (phi-3-vision-4.2b) against the JAX
package, on the CPU in f32 (plain attention), at reduced size (2 layers,
d 256, 4 heads of hd 64, a 16-patch image).

* The model: ``forward`` logits over [image; text] (2e-5), ``loss_fn`` with
  the image rows dropped before the dense and the chunked-CE heads (labels
  of -1 masked), and ``prefill(full_cache=True)``'s logits, every layer's
  collected k/v and positions, and ``t = P + S``.
* The engine, each request with its own image, greedy tokens against the
  JAX engine's (a first difference only at an f32 tie of JAX's logits over
  the image and the text): whole-prompt admission at ``prefill_bucket`` 0
  and 8; ``prefix_cache=True, prefill_chunk=4``, which a vision request
  bypasses (no hit on a warm resubmission, outputs equal to the cold run);
  an int8 pool (a first difference only under ``QUANT_MARGIN``; batched ==
  alone); the dense fallback; ``train.serve.generate`` paged and dense; the
  ngram speculative engine (spec-on == spec-off, and JAX's spec tokens).
* The image reaches the model, a vision submit needs its image, and the
  launcher serves the family on the CPU.

The JAX engines compile once each (module fixtures); every prompt pads to
one 16-token bucket.
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
from repro.models import Runtime, forward, init_params, loss_fn
from repro.models import prefill as jprefill
from repro.models.stack import layer_specs as jlayer_specs
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.checkpoint import params_from_jax
from repro_torch.configs import get_reduced as t_get_reduced
from repro_torch.configs.base import reduced
from repro_torch.launch import serve as launch_serve
from repro_torch.models import Runtime as TRuntime
from repro_torch.models import forward as tforward
from repro_torch.models import init_params as tinit_params
from repro_torch.models import loss_fn as tloss_fn
from repro_torch.models import prefill as tprefill
from repro_torch.serve import EngineConfig, ServeEngine
from repro_torch.train.serve import generate
from test_torch_serve_engine import assert_same_or_quantized_tie, assert_same_or_tie
from test_torch_serve_whole import jax_layers

# pytest-xdist runs several workers on one machine: give torch this worker's share
# of the cores (oversubscribed, the torch side runs many times slower)
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

ARCH = "phi-3-vision-4.2b"
RT = Runtime(dtype=jnp.float32, chunk_q=32)
TRT = TRuntime(dtype=torch.float32)
TOL = 2e-5                       # f32 on both sides, sums in another order
# 13- and 16-token prompts: bucket 8 pads all three to 16, one JAX prefill
# program; requests 0 and 2 share a length, so they batch in generate
LENGTHS = (13, 16, 13)
NEW = 6
ENGINE = dict(max_slots=2, page_size=8, num_pages=33, max_len=64, inner_steps=4)


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(**over):
        key = tuple(sorted(over.items()))
        if key not in cache:
            cfg, tcfg = get_reduced(ARCH), t_get_reduced(ARCH)
            if over:
                cfg, tcfg = jreduced(cfg, **over), reduced(tcfg, **over)
            params = init_params(cfg, jax.random.PRNGKey(0))
            tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
            cache[key] = (cfg, params, tcfg, tparams)
        return cache[key]

    return get


def image(cfg, seed):
    return np.random.RandomState(100 + seed).randn(
        cfg.frontend_tokens, cfg.d_model).astype(np.float32)


def requests(cfg):
    """(prompts, images): LENGTHS, each prompt with its own image."""
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32) for n in LENGTHS]
    return prompts, [image(cfg, i) for i in range(len(prompts))]


def submit_all(eng, prompts, images, max_new=NEW):
    return [eng.submit(p, max_new, frontend_embeds=fe) for p, fe in zip(prompts, images)]


def drive(tcfg, tparams, ecfg, prompts, images, paged=None):
    eng = ServeEngine(tcfg, tparams, TRT, ecfg, paged=paged, device="cpu")
    rids = submit_all(eng, prompts, images)
    out = eng.run()
    return eng, [out[r] for r in rids]


@pytest.fixture(scope="module")
def jax_runs(models):
    """The JAX engine's tokens, one run per (kv dtype, spec tokens, vocab
    override), at bucket 8 / 16: JAX's bucketed prefill is exact
    (tests/test_serve_engine.py:236), so each run is the reference of the
    port at any bucket."""
    cache = {}

    def get(kv_dtype="bf16", spec=0, **over):
        key = (kv_dtype, spec, tuple(sorted(over.items())))
        if key not in cache:
            cfg, params, _, _ = models(**over)
            prompts, images = requests(cfg)
            je = JServeEngine(cfg, params, RT, JEngineConfig(
                **ENGINE, prefill_bucket=16 if spec else 8, kv_dtype=kv_dtype,
                spec_tokens=spec))
            rids = submit_all(je, prompts, images)
            out = je.run()
            cache[key] = (prompts, images, [np.asarray(out[r]) for r in rids], je.stats)
        return cache[key]

    return get


def assert_tokens(cfg, params, prompts, images, want, got):
    for p, fe, w, g in zip(prompts, images, want, got):
        assert g.shape == (NEW,)
        assert_same_or_tie(cfg, params, p, w, g, fe)


# -------------------------------------------------------------------- model
def jbatch(tokens, images):
    return {"tokens": jnp.asarray(tokens), "frontend_embeds": jnp.asarray(images)}


def tbatch(tokens, images):
    return {"tokens": torch.from_numpy(tokens), "frontend_embeds": torch.from_numpy(images)}


def test_forward_matches_jax(models):
    """Logits over [image; text]: P + S rows, the image's too (2e-5)."""
    cfg, params, tcfg, tparams = models()
    tokens = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    images = np.stack([image(cfg, 0), image(cfg, 1)])
    want, _ = forward(cfg, params, jbatch(tokens, images), RT)
    got, aux = tforward(tcfg, tparams, tbatch(tokens, images), TRT)
    assert got.shape == (2, cfg.frontend_tokens + 10, tcfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    assert float(aux) == 0.0


@pytest.mark.parametrize("fused", [False, True], ids=["dense-head", "chunked-ce"])
def test_loss_masks_the_image_prefix_like_jax(models, fused):
    """loss_fn drops the image rows before the head: labels cover the text
    only (some -1). The total, xent and z-loss against JAX's (1e-5), and
    the same loss as the text rows of forward's logits give."""
    cfg, params, tcfg, tparams = models()
    rng = np.random.RandomState(2)
    tokens = rng.randint(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    labels[0, :3] = -1
    labels[1, -2:] = -1
    images = np.stack([image(cfg, 2), image(cfg, 3)])
    jb = dict(jbatch(tokens, images), labels=jnp.asarray(labels))
    tb = dict(tbatch(tokens, images), labels=torch.from_numpy(labels))
    _, want = loss_fn(cfg, params, jb, RT.replace(fused_backward=fused, ce_chunk=256))
    _, got = tloss_fn(tcfg, tparams, tb, TRT.replace(fused_backward=fused, ce_chunk=256))
    for k in ("loss", "xent", "z_loss"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    logits, _ = tforward(tcfg, tparams, tbatch(tokens, images), TRT)
    text = logits[:, cfg.frontend_tokens:]
    ll = torch.log_softmax(text, -1).gather(-1, torch.from_numpy(labels).clamp(min=0).long()[..., None])
    mask = torch.from_numpy(labels >= 0)
    np.testing.assert_allclose(float(got["xent"]), float(-ll[..., 0][mask].mean()), rtol=1e-5)


def test_prefill_logits_caches_and_t_match_jax(models):
    """prefill(full_cache=True) over a padded prompt behind its image,
    gathered at the text's true last position: logits (2e-5), every layer's
    k/v (2e-5) and positions (exactly), and t = P + S."""
    cfg, params, tcfg, tparams = models()
    P, S = cfg.frontend_tokens, 14
    tokens = np.random.RandomState(3).randint(0, cfg.vocab_size, (2, S)).astype(np.int32)
    images = np.stack([image(cfg, 4), image(cfg, 5)])
    horizon, gather = P + S + 8, P + S - 3
    jl, js = jax.jit(lambda p, b: jprefill(cfg, p, b, RT, max_len=horizon, gather_pos=gather,
                                           full_cache=True))(params, jbatch(tokens, images))
    tl, ts = tprefill(tcfg, tparams, tbatch(tokens, images), TRT, max_len=horizon,
                      gather_pos=gather, full_cache=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    assert ts["t"] == int(js["t"]) == P + S
    want = jax_layers(js["caches"], cfg, jlayer_specs(cfg, seq_len=P + S))
    assert len(ts["caches"]) == len(want) == tcfg.n_layers
    for i, (got, ref) in enumerate(zip(ts["caches"], want)):
        assert got["k"].shape == (2, horizon, tcfg.n_kv_heads, tcfg.head_dim)
        np.testing.assert_array_equal(got["pos"].numpy(), ref["pos"], err_msg=f"layer {i}")
        for k in "kv":
            np.testing.assert_allclose(got[k].numpy(), ref[k], atol=TOL, rtol=TOL,
                                       err_msg=f"layer {i} {k}")


# ------------------------------------------------------------------- engine
@pytest.mark.parametrize("bucket", [0, 8])
def test_whole_prompt_tokens_match_jax(models, jax_runs, bucket):
    """Whole-prompt admission: each slot starts at P + its text, and the
    pages, stats and tokens follow JAX's."""
    cfg, params, tcfg, tparams = models()
    prompts, images, want, jstats = jax_runs()
    eng, got = drive(tcfg, tparams, EngineConfig(**ENGINE, prefill_bucket=bucket),
                     prompts, images)
    assert_tokens(cfg, params, prompts, images, want, got)
    assert eng.stats["prompt_tokens"] == jstats["prompt_tokens"] == sum(
        len(p) + cfg.frontend_tokens for p in prompts)
    assert eng.stats["kv_bytes"] == jstats["kv_bytes"]
    assert "prefill_chunks" not in eng.stats
    eng.pool.check()
    assert eng.pool.pages_in_use == 0


def test_prefix_cache_is_bypassed(models, jax_runs):
    """tests/test_serve_prefix.py:131's vision case: with the prefix cache
    and chunked prefill requested, a vision request is admitted whole, is
    never matched or inserted, and a warm resubmission equals the cold run
    (and JAX's whole-prompt tokens)."""
    cfg, params, tcfg, tparams = models()
    prompts, images, want, _ = jax_runs()
    eng = ServeEngine(tcfg, tparams, TRT, EngineConfig(**ENGINE, prefix_cache=True,
                                                       prefill_chunk=4), device="cpu")
    rids = submit_all(eng, prompts, images)
    cold = eng.run()
    rids2 = submit_all(eng, prompts, images)
    warm = eng.run()
    for a, b in zip(rids, rids2):
        np.testing.assert_array_equal(cold[a], warm[b])
    assert_tokens(cfg, params, prompts, images, want, [cold[r] for r in rids])
    assert eng.stats["prefix_hits"] == 0 and eng.stats["prefix_cached_tokens"] == 0
    assert eng.prefix.pages_cached() == 0 and "prefill_chunks" not in eng.stats
    eng.pool.check()
    assert eng.pool.pages_in_use == 0


def test_int8_pool_tokens_match_jax_and_batched_equals_alone(models, jax_runs):
    """tests/test_serve_engine.py:357's vision case: over an int8 pool a
    first difference from JAX's int8 engine only under QUANT_MARGIN (the
    codecs' eager/jit gap, ROADMAP queue 3); batched == alone bitwise."""
    cfg, params, tcfg, tparams = models()
    prompts, images, want, _ = jax_runs("int8")
    ecfg = EngineConfig(**ENGINE, prefill_bucket=8, kv_dtype="int8")
    eng, got = drive(tcfg, tparams, ecfg, prompts, images)
    assert eng._dev["caches"]["k"].dtype == torch.int8
    for p, fe, w, g in zip(prompts, images, want, got):
        assert_same_or_quantized_tie(cfg, params, p, w, g, "int8", fe)
    for i in (0, 1):
        _, alone = drive(tcfg, tparams, dataclasses.replace(ecfg, max_slots=1),
                         [prompts[i]], [images[i]])
        np.testing.assert_array_equal(alone[0], got[i], err_msg=f"request {i}")


def test_dense_engine_tokens_match_jax(models, jax_runs):
    """paged=False: the dense fallback batches requests 0 and 2 (one
    length) with their images over rings of P + S + new rows."""
    cfg, params, tcfg, tparams = models()
    prompts, images, want, jstats = jax_runs()
    eng, got = drive(tcfg, tparams, EngineConfig(**ENGINE), prompts, images, paged=False)
    assert_tokens(cfg, params, prompts, images, want, got)
    assert eng.kv_pool_bytes_per_device() == 0
    assert eng.stats["kv_bytes"][0] > 0


@pytest.mark.parametrize("paged", [False, True])
def test_generate_matches_jax(models, jax_runs, paged):
    """train.serve.generate over a batch of requests 0 and 2 (one length),
    each behind its image: dense rings, or the engine sized by P + S."""
    cfg, params, tcfg, tparams = models()
    prompts, images, want, _ = jax_runs()
    batch = {"tokens": np.stack([prompts[0], prompts[2]]),
             "frontend_embeds": np.stack([images[0], images[2]])}
    out, _ = generate(tcfg, tparams, batch, TRT, NEW, paged=paged)
    assert out.shape == (2, NEW)
    for b, i in enumerate((0, 2)):
        assert_same_or_tie(cfg, params, prompts[i], want[i], out[b].numpy(), images[i])


def test_spec_ngram_matches_jax_and_spec_off(models, jax_runs):
    """tests/test_serve_spec.py's vision case on a vocab-2 model (greedy
    streams cycle, so prompt lookup lands drafts): the verify pass runs past
    the image; the port's spec tokens and counters equal JAX's spec
    engine's, and the port's spec-off tokens."""
    over = dict(name="phi-3-vision-bin", vocab_size=2)
    cfg, params, tcfg, tparams = models(**over)
    prompts, images, want, jstats = jax_runs(spec=3, **over)
    ecfg = EngineConfig(**ENGINE, prefill_bucket=16, spec_tokens=3)
    eng, on = drive(tcfg, tparams, ecfg, prompts, images)
    _, off = drive(tcfg, tparams, dataclasses.replace(ecfg, spec_tokens=0), prompts, images)
    for i, (w, a, b) in enumerate(zip(want, on, off)):
        np.testing.assert_array_equal(a, w, err_msg=f"request {i} vs JAX")
        np.testing.assert_array_equal(a, b, err_msg=f"request {i} vs spec-off")
    for k in ("spec_verify_calls", "spec_drafted_tokens", "spec_accepted_tokens"):
        assert eng.stats[k] == jstats[k], k
    assert eng.stats["spec_accepted_tokens"] > 0


# ---------------------------------------------------------- image and input
def test_the_image_reaches_the_model(models):
    """The same text behind another image: other first-token logits and
    another stream."""
    _, _, tcfg, tparams = models()
    prompts, images = requests(tcfg)
    other = [image(tcfg, 10 + i) for i in range(len(prompts))]
    ecfg = EngineConfig(**ENGINE)
    _, a = drive(tcfg, tparams, ecfg, prompts, images)
    _, b = drive(tcfg, tparams, ecfg, prompts, other)
    assert any(not np.array_equal(x, y) for x, y in zip(a, b))
    tokens = np.stack([prompts[0], prompts[0]])
    logits, _ = tprefill(tcfg, tparams, tbatch(tokens, np.stack([images[0], other[0]])), TRT)
    assert float((logits[0] - logits[1]).abs().max()) > 0.1 * float(logits[0].abs().max())


def test_vision_submit_needs_its_image(models):
    """A vision submit without an image, or with one of another shape, and
    a text config's submit with one, raise ValueError before any state
    changes."""
    _, _, tcfg, tparams = models()
    eng = ServeEngine(tcfg, tparams, TRT, EngineConfig(**ENGINE), device="cpu")
    p = np.arange(5, dtype=np.int32)
    with pytest.raises(ValueError, match="frontend_embeds"):
        eng.submit(p, 3)
    with pytest.raises(ValueError, match="frontend_embeds"):
        eng.submit(p, 3, frontend_embeds=np.zeros((tcfg.frontend_tokens - 1, tcfg.d_model)))
    assert eng._next_rid == 0 and not eng.busy
    text = t_get_reduced("granite-8b")
    teng = ServeEngine(text, tinit_params(text, device="cpu", dtype=torch.float32), TRT,
                       EngineConfig(**ENGINE), device="cpu")
    with pytest.raises(ValueError, match="no modality frontend"):
        teng.submit(p, 3, frontend_embeds=image(tcfg, 0))


@pytest.mark.parametrize("argv,expect", [
    (["--paged"], "admission by whole prompt"),
    (["--paged", "--prefill-chunk", "4"], "admission by chunks of 4"),
    (["--batch", "2"], "dense: 8 tokens"),
])
def test_launcher_serves_vision_on_cpu(argv, expect, capsys):
    launch_serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                       "--new-tokens", "4", "--temperature", "0"] + argv)
    out = capsys.readouterr().out
    assert "phi-3-vision-4.2b-reduced" in out and expect in out, out
