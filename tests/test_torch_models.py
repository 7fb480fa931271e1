"""The port's model layers and paged serving path against the JAX package.

* Layers: norm, RoPE, MLP, embedding and logits against ``repro.models.layers``
  on the same numpy inputs (f32, 1e-5).
* Paths: prompt chunks through ``prefill_chunk_paged`` and then decode steps
  through ``decode_step_paged``, port vs JAX (``use_paged_kernel`` off), on
  reduced granite-8b (MQA), granite-8b with 2 kv heads (GQA, G=2) and
  gemma3-1b (6 layers, window 64, prompt longer than the window); logits
  agree to 1e-4 relative to their largest magnitude, in f32.
* Converter: ``params_from_jax`` takes the nested tree and the flat ckpt
  keys alike, and ``params_to_numpy`` round-trips it.
* Import isolation: the port and chip_smoke.py import neither jax nor repro.
"""
import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _flatten
from repro.configs import get_reduced
from repro.models import Runtime, init_params
from repro.models import layers as jl
from repro.models import lm as jlm
from repro_torch.checkpoint import params_from_jax, params_to_numpy
from repro_torch.configs import get_reduced as t_get_reduced
from repro_torch.models import Runtime as TRuntime
from repro_torch.models import decode_step_paged, init_paged_state, prefill_chunk_paged
from repro_torch.models import layers as tl

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-4


def rng_arrays(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm_apply_matches_jax(norm):
    x, scale, bias = rng_arrays(0, (3, 5, 64), (64,), (64,))
    p = {"scale": jnp.asarray(scale)}
    if norm == "layernorm":
        p["bias"] = jnp.asarray(bias)
    want = np.asarray(jl.norm_apply(p, jnp.asarray(x), norm))
    got = tl.norm_apply(
        tl.Norm(torch.from_numpy(scale),
                torch.from_numpy(bias) if norm == "layernorm" else None),
        torch.from_numpy(x), norm,
    )
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_rope_apply_matches_jax():
    (x,) = rng_arrays(1, (2, 7, 3, 32))
    pos = np.array([[0, 1, 2, 40, 41, 42, 500]] * 2, np.int32)
    want = np.asarray(jl.rope_apply(jnp.asarray(x), jnp.asarray(pos), 10_000.0))
    got = tl.rope_apply(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("gated", [True, False])
def test_mlp_apply_matches_jax(gated):
    x, up, down, gate = rng_arrays(2, (2, 4, 32), (32, 48), (48, 32), (32, 48))
    p = {"w_up": jnp.asarray(up), "w_down": jnp.asarray(down)}
    if gated:
        p["w_gate"] = jnp.asarray(gate)
    want = np.asarray(jl.mlp_apply(p, jnp.asarray(x), gated))
    mlp = tl.MLP(torch.from_numpy(up), torch.from_numpy(down),
                 torch.from_numpy(gate) if gated else None)
    got = tl.mlp_apply(mlp, torch.from_numpy(x), gated)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("tied", [True, False])
def test_embed_and_logits_match_jax(tied):
    table, head, x = rng_arrays(3, (96, 16), (16, 96), (2, 3, 16))
    ids = np.array([[0, 5, 95], [7, 7, 1]], np.int32)
    jembed, jhead = {"table": jnp.asarray(table)}, {"w": jnp.asarray(head)}
    embed, thead = tl.Embed(torch.from_numpy(table)), tl.Head(torch.from_numpy(head))
    np.testing.assert_array_equal(
        tl.embed_apply(embed, torch.from_numpy(ids), torch.float32).numpy(),
        np.asarray(jl.embed_apply(jembed, jnp.asarray(ids), jnp.float32)),
    )
    want = np.asarray(jl.logits_apply(jhead, jembed, jnp.asarray(x), tied))
    got = tl.logits_apply(thead, embed, torch.from_numpy(x), tied)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------------- paths
_JIT_PREFILL = jax.jit(jlm.prefill_chunk_paged, static_argnums=(0, 7, 8))
_JIT_DECODE = jax.jit(jlm.decode_step_paged, static_argnums=(0, 4, 5))
PATHS = [
    ("granite-8b", {}),                    # MQA (reduced: 4 q heads, 1 kv)
    ("granite-8b", {"n_kv_heads": 2}),     # GQA, G = 2
    ("gemma3-1b", {}),                     # 5 local (window 64) + 1 global
]


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("name,over", PATHS, ids=[f"{n}{o}" for n, o in PATHS])
def test_prefill_then_decode_logits_match_jax(name, over):
    cfg, tcfg = get_reduced(name, **over), t_get_reduced(name, **over)
    params = init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    rt, trt = Runtime(dtype=jnp.float32), TRuntime(dtype=torch.float32)
    N, page, max_len, T, plen = 24, 8, 128, 16, 90     # 90 > gemma's window 64
    jst = jlm.init_paged_state(cfg, 2, rt, num_pages=N, page_size=page, max_len=max_len)
    tst = init_paged_state(tcfg, 2, trt, num_pages=N, page_size=page, max_len=max_len,
                           device="cpu")
    row = np.zeros(max_len // page, np.int32)
    row[:13] = np.arange(1, 14)
    jst["tables"] = jst["tables"].at[0].set(row)
    tst["tables"][0] = torch.from_numpy(row)
    prompt = np.random.RandomState(1).randint(0, cfg.vocab_size, plen).astype(np.int32)
    caches = jst["caches"]
    for s in range(0, plen, T):          # last chunk ragged: 90 = 5 * 16 + 10
        n = min(T, plen - s)
        chunk = np.zeros(T, np.int32)
        chunk[:n] = prompt[s:s + n]
        want, caches = _JIT_PREFILL(cfg, params, caches, jnp.asarray(row),
                                    jnp.asarray(chunk), jnp.int32(s), jnp.int32(n),
                                    rt, max_len)
        got = prefill_chunk_paged(tcfg, tparams, tst["caches"], tst["tables"][0],
                                  torch.from_numpy(chunk), s, n, trt, max_len)
        assert _rel(got.numpy(), np.asarray(want)) < REL, s
    jst = dict(jst, caches=caches, lengths=jnp.asarray([plen, 0], jnp.int32))
    tst["lengths"][0] = plen
    active = np.array([True, False])
    tok = np.array([int(np.argmax(np.asarray(want))), 0], np.int32)
    for step in range(4):
        want, jst = _JIT_DECODE(cfg, params, jst, jnp.asarray(tok), rt, max_len,
                                jnp.asarray(active))
        got = decode_step_paged(tcfg, tparams, tst, torch.from_numpy(tok), trt,
                                max_len, active=torch.from_numpy(active))
        assert _rel(got.numpy()[0], np.asarray(want)[0]) < REL, step
        tok = np.array([int(np.argmax(np.asarray(want)[0])), 0], np.int32)
    np.testing.assert_array_equal(tst["lengths"].numpy(), [plen + 4, 0])


# --------------------------------------------------------------- converter
@pytest.mark.parametrize("name", ["granite-8b", "gemma3-1b"])
def test_params_from_jax_round_trips_nested_and_flat(name):
    cfg, tcfg = get_reduced(name), t_get_reduced(name)
    nested = jax.tree.map(np.asarray, init_params(cfg, jax.random.PRNGKey(2)))
    flat = _flatten(nested)
    assert "stack/g0/p0/mixer/wq" in flat
    a = params_from_jax(nested, tcfg, device="cpu")
    b = params_from_jax(flat, tcfg, device="cpu")
    back_a, back_b = _flatten(params_to_numpy(a)), _flatten(params_to_numpy(b))
    assert set(back_a) == set(flat) == set(back_b)
    for k, v in flat.items():
        np.testing.assert_array_equal(back_a[k], v, err_msg=k)
        np.testing.assert_array_equal(back_b[k], v, err_msg=k)
    assert len(a.stack.layers) == cfg.n_layers
    assert (a.head is None) == cfg.tie_embeddings


def test_params_from_jax_stores_matmuls_in_compute_dtype():
    cfg, tcfg = get_reduced("granite-8b"), t_get_reduced("granite-8b")
    nested = jax.tree.map(np.asarray, init_params(cfg, jax.random.PRNGKey(2)))
    p = params_from_jax(nested, tcfg, device="cpu", dtype=torch.bfloat16)
    layer = p.stack.layers[0]
    assert layer.mixer.wq.dtype == torch.bfloat16
    assert layer.ffn.w_up.dtype == torch.bfloat16
    assert layer.norm1.scale.dtype == torch.float32
    assert p.head.w.dtype == torch.float32


def test_init_params_tree_matches_jax_shapes():
    from repro_torch.models import init_params as t_init

    cfg, tcfg = get_reduced("gemma3-1b"), t_get_reduced("gemma3-1b")
    want = _flatten(jax.tree.map(np.asarray, init_params(cfg, jax.random.PRNGKey(0))))
    got = _flatten(params_to_numpy(t_init(tcfg, seed=0, device="cpu",
                                          dtype=torch.float32)))
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    wq = got["stack/g0/p0/mixer/wq"]
    assert abs(wq.std() * np.sqrt(tcfg.d_model) - want[
        "stack/g0/p0/mixer/wq"].std() * np.sqrt(cfg.d_model)) < 0.05


# ---------------------------------------------------------- import isolation
def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_sources_import_neither_jax_nor_repro():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    files = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for sub in ("train/loop.py", "optim/optimizers.py", "core/precision.py",
                "data/pipeline.py", "checkpoint/ckpt.py", "launch/train.py",
                "kernels/flash_attention/ops.py", "kernels/rmsnorm/ops.py",
                "kernels/chunked_ce/ops.py"):
        assert f"src/repro_torch/{sub}" in files, sub
    assert not bad, bad


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch.serve, repro_torch.launch.serve, "
        "repro_torch.checkpoint, repro_torch.configs, repro_torch.train, "
        "repro_torch.optim, repro_torch.core, repro_torch.data, "
        "repro_torch.launch.train, repro_torch.launch.profile_train, "
        "repro_torch.checkpoint.ckpt, repro_torch.kernels.flash_attention, "
        "repro_torch.kernels.rmsnorm, repro_torch.kernels.chunked_ce\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "print(bad)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout
