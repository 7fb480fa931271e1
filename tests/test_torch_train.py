"""The port's single-device training path against the JAX package's, on
the CPU (plain versions of the kernels).

* Data: the port's ``DataPipeline`` batches equal JAX's bitwise.
* Chunked CE: loss, dx and dw against JAX's ``chunked_ce`` at chunks 128
  and 1000 with masked labels; no (B, S, V) tensor is saved for backward.
* Model: ``loss_fn`` and its gradients against JAX at f32 on reduced
  gemma3-1b (seq 128 > window 64) and granite-8b, parameters carried across
  by ``params_from_jax``; ``fused_backward`` off, and on for one small case
  (the JAX side then runs its Pallas kernels in interpret mode).
* Training: three steps of ``fit`` against JAX's
  ``make_train_step(mode="single")`` from the same state and batches:
  per-step loss and grad-norm, then params and AdamW m/v, for remat
  none/full/dots (one JAX trajectory), bf16, and fp16 with loss scaling.
* Optimizers and loss scaling: one update of each optimizer, and the
  non-finite skip, against JAX.
* Checkpoints: a port checkpoint restores in ``repro.checkpoint.ckpt`` and
  the other way round.
* The launcher on the CPU; the modes this slice leaves out raise; the public
  functions that place state take ``device`` as a required keyword.
"""
import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.checkpoint.ckpt import _flatten
from repro.configs import get_reduced
from repro.core import precision as jprec
from repro.data.pipeline import DataPipeline as JDataPipeline
from repro.kernels.chunked_ce import chunked_ce as jax_chunked_ce
from repro.models import Runtime, init_params
from repro.models import lm as jlm
from repro.optim import get as jget
from repro.optim.base import Schedule as JSchedule
from repro.train.loop import TrainConfig as JTrainConfig
from repro.train.loop import make_state as jmake_state
from repro.train.loop import make_train_step as jmake_train_step
from repro_torch.checkpoint import ckpt, params_from_jax, state_from_jax, state_to_numpy
from repro_torch.configs import get_reduced as t_get_reduced
from repro_torch.core import precision as tprec
from repro_torch.core.pipeline import pipeline_apply, pipeline_grads
from repro_torch.data import DataPipeline
from repro_torch.kernels.chunked_ce import chunked_ce, chunked_ce_plain
from repro_torch.launch import train as launch_train
from repro_torch.models import Runtime as TRuntime
from repro_torch.models import init_paged_state, loss_fn, masked_token_ce
from repro_torch.models.stack import init_stack_pool, layer_specs
from repro_torch.optim import Schedule, get
from repro_torch.train import TrainConfig, fit, make_train_step

# pytest-xdist runs several workers on one machine: give torch this worker's share
# of the cores (oversubscribed, the torch side runs many times slower)
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

LR = 1e-3
STEPS = 3


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


# --------------------------------------------------------------------- data
@pytest.mark.parametrize("name", ["gemma3-1b", "phi-3-vision-4.2b"])
def test_data_pipeline_batches_equal_jax_bitwise(name):
    cfg, tcfg = get_reduced(name), t_get_reduced(name)
    a, b = JDataPipeline(cfg, 3, 40, seed=5), DataPipeline(tcfg, 3, 40, seed=5)
    try:
        for _ in range(3):
            ja, tb = next(a), next(b)
            assert set(ja) == set(tb)
            for k in ja:
                assert ja[k].dtype == tb[k].dtype, k
                np.testing.assert_array_equal(ja[k], tb[k], err_msg=k)
    finally:
        a.close()
        b.close()


# --------------------------------------------------------------- chunked CE
def _ce_case(seed, B=2, S=24, d=32, V=1500):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, d).astype(np.float32)
    w = (0.1 * rng.randn(V, d)).astype(np.float32)
    labels = rng.randint(0, V, (B, S)).astype(np.int32)
    labels[0, :5] = -1                                  # masked positions
    return x, w, labels


@pytest.mark.parametrize("chunk", [128, 1000])
def test_chunked_ce_loss_and_grads_match_jax(chunk):
    x, w, labels = _ce_case(chunk)
    safe = np.maximum(labels, 0)

    def jloss(x_, w_):
        lab, logz = jax_chunked_ce(x_, w_, jnp.asarray(safe), chunk)
        xent, zl = jlm.masked_token_ce(lab - logz, logz, jnp.asarray(labels))
        return xent + zl

    want, (jdx, jdw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    lab, logz = chunked_ce(tx, tw, torch.from_numpy(safe), chunk)
    xent, zl = masked_token_ce(lab - logz, logz, torch.from_numpy(labels))
    dx, dw = torch.autograd.grad(xent + zl, (tx, tw))
    # f32 on both sides; the online logsumexp and the scatter-add run in
    # another order: 1e-5
    np.testing.assert_allclose(float((xent + zl).detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), atol=1e-6, rtol=1e-5)
    # and the port's own dense oracle, which holds (B, S, V)
    want_lab, want_logz = chunked_ce_plain(torch.from_numpy(x), torch.from_numpy(w),
                                           torch.from_numpy(safe))
    torch.testing.assert_close(lab.detach(), want_lab, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(logz.detach(), want_logz, atol=1e-5, rtol=1e-5)


def test_chunked_ce_saves_no_vocab_sized_activation():
    x, w, labels = _ce_case(7)
    B, S, _ = x.shape
    V = w.shape[0]
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        lab, logz = chunked_ce(tx, tw, torch.from_numpy(np.maximum(labels, 0)), 128)
    assert saved, "nothing saved for backward"
    assert all(np.prod(s) < B * S * V for s in saved), saved
    (lab.sum() + logz.sum()).backward()
    assert tx.grad.shape == tx.shape and tw.grad.shape == tw.shape


# -------------------------------------------------------------------- model
MODEL_CASES = [
    ("gemma3-1b", 2, 128, False),     # 5 local (window 64) + 1 global layer
    ("granite-8b", 2, 64, False),     # untied head
    ("granite-8b", 1, 32, True),      # chunked CE; JAX flash/RMSNorm in interpret mode
]


@pytest.mark.parametrize("name,B,S,fused", MODEL_CASES,
                         ids=[f"{c[0]}-S{c[2]}-fused{c[3]}" for c in MODEL_CASES])
def test_loss_fn_and_grads_match_jax(name, B, S, fused):
    cfg, tcfg = get_reduced(name), t_get_reduced(name)
    params = init_params(cfg, jax.random.PRNGKey(1))
    rng = np.random.RandomState(2)
    toks = rng.randint(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[:, :3] = -1
    batch = {"tokens": toks[:, :-1], "labels": labels}
    rt = Runtime(dtype=jnp.float32, fused_backward=fused, use_flash_kernel=fused,
                 ce_chunk=256)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(cfg, p, jbatch, rt), has_aux=True,
    ))(params)
    tparams = params_from_jax(numpy_tree(params), tcfg, device="cpu").requires_grad_(True)
    trt = TRuntime(dtype=torch.float32, fused_backward=fused, ce_chunk=256)
    tl, tm = loss_fn(tcfg, tparams, {k: torch.from_numpy(v) for k, v in batch.items()}, trt)
    grads = torch.autograd.grad(tl, list(tparams.parameters()))
    # f32 throughout; attention and the head sum in another order: 1e-5
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["z_loss"]), float(jm["z_loss"]), rtol=1e-4)
    from repro_torch.checkpoint.convert import leaves_to_flat, param_leaves

    got = leaves_to_flat(param_leaves(tparams, grads))
    want = _flatten(numpy_tree(jg))
    assert set(got) == set(want)
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-6)
        np.testing.assert_allclose(got[k], want[k], atol=2e-5 * scale, rtol=1e-3,
                                   err_msg=k)


# ----------------------------------------------------------------- training
def _jax_run(name, precision, fused=False):
    cfg = get_reduced(name)
    jtc = JTrainConfig(precision=precision, fused_backward=fused, log_every=1)
    opt = jget("adamw", LR)
    state = jmake_state(cfg, opt, jtc, seed=0)
    init = numpy_tree(state)
    step = jmake_train_step(cfg, opt, jtc)
    data = JDataPipeline(cfg, 2, 128, seed=0)
    curve = []
    try:
        for _ in range(STEPS):
            state, m = step(state, {k: jnp.asarray(v) for k, v in next(data).items()})
            curve.append((float(m["loss"]), float(m["grad_norm"])))
    finally:
        data.close()
    return init, curve, _flatten(numpy_tree(state))


@pytest.fixture(scope="module")
def jax_runs():
    cache = {}

    def get_run(name, precision):
        if (name, precision) not in cache:
            cache[name, precision] = _jax_run(name, precision)
        return cache[name, precision]

    return get_run


# per precision: (loss rtol, grad-norm rtol, params and m/v error as a share
# of their norm). f32: losses agree to ~1e-7 and grad norms to ~1e-6,
# summation order only. bf16/fp16: the frameworks round the low-precision
# activations at other places (JAX casts the softmax weights to the compute
# dtype before p @ v, the port keeps them f32; JAX sums the embedding
# gradient in the compute dtype, the port in f32), so losses agree to ~5e-4
# and grad norms to ~1e-3, and m/v (bf16: ~4%, most of it the embedding
# rows) and params (~0.7%) follow. Params move by Adam's normalized update,
# lr * g / (|g| + eps) at step 1, so an element whose early gradients sit at
# the roundoff level moves by up to lr either way: no element may differ by
# more than 2 * STEPS * lr, and in f32 at most F32_SHARE of the elements by
# more than 1e-6 + 1e-2 * lr.
TRAIN_TOL = {
    "f32": (1e-5, 1e-4, 1e-4, 1e-3),
    "bf16": (1e-3, 3e-3, 2e-2, 1e-1),
    "fp16": (1e-3, 3e-3, 1e-2, 3e-2),
}
F32_SHARE = 2e-4
TRAIN_CASES = [
    ("gemma3-1b", "f32", "none"),
    ("gemma3-1b", "f32", "full"),
    ("gemma3-1b", "f32", "dots"),
    ("granite-8b", "bf16", "none"),
    ("granite-8b", "fp16", "none"),
]


@pytest.mark.parametrize("name,precision,remat", TRAIN_CASES,
                         ids=["-".join(c) for c in TRAIN_CASES])
def test_three_steps_of_fit_match_jax(jax_runs, name, precision, remat):
    init, curve, final = jax_runs(name, precision)
    tcfg = t_get_reduced(name)
    state = state_from_jax(init, tcfg, device="cpu")
    tc = TrainConfig(precision=precision, remat=remat, log_every=1)
    data = DataPipeline(tcfg, 2, 128, seed=0)
    try:
        state, hist = fit(tcfg, tc, data, STEPS, get("adamw", LR), state=state,
                          log=lambda line: None)
    finally:
        data.close()
    loss_rtol, gnorm_rtol, param_rel, mv_rel = TRAIN_TOL[precision]
    for h, (jl, jg) in zip(hist, curve):
        np.testing.assert_allclose(h["loss"], jl, rtol=loss_rtol)
        np.testing.assert_allclose(h["grad_norm"], jg, rtol=gnorm_rtol)
    got = _flatten(state_to_numpy(state))
    assert set(got) == set(final)
    for k, want in final.items():
        if want.dtype.kind != "f":
            np.testing.assert_array_equal(got[k], want, err_msg=k)
            continue
        err = np.abs(got[k] - want)
        rel = np.linalg.norm(err) / max(float(np.linalg.norm(want)), 1e-30)
        if k.startswith("params/"):
            assert rel <= param_rel, (k, rel)
            assert err.max() <= 2 * STEPS * LR, (k, err.max())
            if precision == "f32":
                share = (err > 1e-6 + 1e-2 * LR).mean()
                assert share <= F32_SHARE, (k, share)
        else:
            assert rel <= mv_rel, (k, rel)
    assert int(state["step"]) == STEPS


def test_remat_modes_give_the_same_trajectory():
    tcfg = t_get_reduced("gemma3-1b")
    curves = {}
    for remat in ("none", "full", "dots"):
        tc = TrainConfig(remat=remat, remat_period=2, log_every=1)
        opt = get("adamw", LR)
        from repro_torch.train import make_state

        state = make_state(tcfg, opt, tc, seed=3, device="cpu")
        data = DataPipeline(tcfg, 2, 64, seed=1)
        try:
            state, hist = fit(tcfg, tc, data, 2, opt, state=state, log=lambda s: None)
        finally:
            data.close()
        curves[remat] = ([h["loss"] for h in hist],
                         [p.detach().clone() for p in state["params"].parameters()])
    # the losses are the same bits; recomputing a group in the backward
    # changes the order of some f32 gradient sums, a few ulp (<= 1.2e-6 on
    # params after 2 steps), hence 1e-5
    for remat in ("full", "dots"):
        assert curves[remat][0] == curves["none"][0]
        for a, b in zip(curves[remat][1], curves["none"][1]):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


# ------------------------------------------------- optimizers and loss scale
OPT_CASES = [
    ("sgd", {}),
    ("adamw", {"weight_decay": 0.1}),
    ("lars", {}),
    ("lamb", {}),
]


@pytest.mark.parametrize("name,kw", OPT_CASES, ids=[c[0] for c in OPT_CASES])
def test_optimizer_updates_match_jax(name, kw):
    rng = np.random.RandomState(4)
    params = [rng.randn(5, 3).astype(np.float32), rng.randn(7).astype(np.float32)]
    grads = [[rng.randn(*p.shape).astype(np.float32) for p in params] for _ in range(2)]
    sched = JSchedule(base_lr=0.1, warmup_steps=1, total_steps=4)
    tsched = Schedule(base_lr=0.1, warmup_steps=1, total_steps=4)
    jopt, topt = jget(name, sched, **kw), get(name, tsched, **kw)
    jp, js = [jnp.asarray(p) for p in params], None
    tp = [torch.from_numpy(p.copy()) for p in params]
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        ju, js = jopt.update([jnp.asarray(x) for x in g], js, jp)
        jp = [p + u for p, u in zip(jp, ju)]
        tu, ts = topt.update([torch.from_numpy(x) for x in g], ts, tp)
        tp = [p + u for p, u in zip(tp, tu)]
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-5)


def test_loss_scale_skips_nonfinite_and_halves_like_jax():
    jpol, tpol = jprec.PrecisionPolicy.fp16(), tprec.PrecisionPolicy.fp16()
    js, ts = jprec.init_scale_state(jpol), tprec.init_scale_state(tpol, device="cpu")
    for bad in (False, True, False):
        g = np.full(3, 2.0 ** 14, np.float32)
        if bad:
            g[1] = np.inf
        jg, js, jf = jprec.unscale_and_check([jnp.asarray(g)], js, jpol)
        tg, ts, tf = tprec.unscale_and_check([torch.from_numpy(g)], ts, tpol)
        assert bool(jf) == bool(tf) == (not bad)
        assert float(js["scale"]) == float(ts["scale"])
        assert int(js["good_steps"]) == int(ts["good_steps"])
        if not bad:
            np.testing.assert_array_equal(tg[0].numpy(), np.asarray(jg[0]))


def test_nonfinite_step_leaves_params_and_optimizer_untouched():
    tcfg = t_get_reduced("granite-8b")
    tc = TrainConfig(precision="fp16")
    opt = get("adamw", LR)
    from repro_torch.train import make_state

    state = make_state(tcfg, opt, tc, seed=0, device="cpu")
    before = [p.detach().clone() for p in state["params"].parameters()]
    batch = {"tokens": torch.zeros(1, 8, dtype=torch.int32),
             "labels": torch.zeros(1, 8, dtype=torch.int32)}
    state["scale"]["scale"].fill_(float("inf"))         # every grad overflows
    state, m = make_train_step(tcfg, opt, tc)(state, batch)
    assert float(m["loss_scale"]) == float("inf") * 0.5 or float(m["loss_scale"]) > 0
    for a, b in zip(state["params"].parameters(), before):
        assert torch.equal(a.detach(), b)
    assert int(state["opt"]["step"]) == 0 and int(state["step"]) == 1


# -------------------------------------------------------------- checkpoints
def test_port_checkpoint_restores_in_jax(tmp_path):
    cfg, tcfg = get_reduced("granite-8b"), t_get_reduced("granite-8b")
    tc = TrainConfig(log_every=1)
    opt = get("adamw", LR)
    from repro_torch.train import make_state

    state = make_state(tcfg, opt, tc, seed=1, device="cpu")
    data = DataPipeline(tcfg, 2, 32, seed=0)
    try:
        state, _ = fit(tcfg, tc, data, 2, opt, state=state, log=lambda s: None)
    finally:
        data.close()
    ckpt.save(str(tmp_path), 2, state)
    assert ckpt.latest_step(str(tmp_path)) == jckpt.latest_step(str(tmp_path)) == 2
    jtc = JTrainConfig()
    template = jmake_state(cfg, jget("adamw", LR), jtc, seed=9)
    restored = _flatten(numpy_tree(jckpt.restore(str(tmp_path), template)))
    want = _flatten(state_to_numpy(state))
    assert set(restored) == set(want)
    for k in want:
        np.testing.assert_array_equal(restored[k], want[k], err_msg=k)


def test_jax_checkpoint_restores_in_port(tmp_path):
    cfg, tcfg = get_reduced("gemma3-1b"), t_get_reduced("gemma3-1b")
    jstate = jmake_state(cfg, jget("adamw", LR), JTrainConfig(precision="fp16"), seed=4)
    jstate["opt"]["m"] = jax.tree.map(lambda a: a + 0.5, jstate["opt"]["m"])
    jstate["step"] = jnp.asarray(7, jnp.int32)
    jckpt.save(str(tmp_path), 7, jstate)
    from repro_torch.train import make_state

    state = make_state(tcfg, get("adamw", LR), TrainConfig(precision="fp16"), seed=0,
                       device="cpu")
    ckpt.restore(str(tmp_path), state)
    got, want = _flatten(state_to_numpy(state)), _flatten(numpy_tree(jstate))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # a partial restore leaves the rest alone
    fresh = make_state(tcfg, get("adamw", LR), TrainConfig(), seed=0, device="cpu")
    ckpt.restore(str(tmp_path), fresh, subset="params/")
    assert int(fresh["step"]) == 0 and float(fresh["opt"]["m"][0].abs().max()) == 0.0


# ---------------------------------------------------------------- launcher
def test_launcher_trains_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_train.main(["--arch", "gemma3-1b", "--reduced", "--device", "cpu",
                           "--steps", "2", "--batch", "2", "--seq", "32"])
    text = out.getvalue()
    assert "train main OK" in text and "step    2 loss=" in text, text


def test_launcher_trains_adam8bit_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_train.main(["--arch", "gemma3-1b", "--reduced", "--device", "cpu",
                           "--steps", "2", "--batch", "2", "--seq", "32",
                           "--optimizer", "adam8bit"])
    text = out.getvalue()
    assert "train main OK" in text and "step    2 loss=" in text, text
    assert "optimizer state adam8bit" in text, text


def test_launcher_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "gemma3-1b", "--steps", "1"])


# -------------------------------------------------------------- rejections
REJECTED = [
    ("compression", lambda: TrainConfig(compression="topk")),
    ("zero", lambda: TrainConfig(zero_stage=1)),
    # the P-device pipeline runners (the single-device one is ported)
    ("pipe", lambda: pipeline_grads()),
    ("microbatches", lambda: pipeline_apply()),
    ("mode", lambda: make_train_step(t_get_reduced("granite-8b"), get("adamw", LR),
                                     TrainConfig(), mode="dp_compressed")),
    ("offload", lambda: TRuntime(remat="offload")),
    ("onebit_adam_data_axis", lambda: get("onebit_adam", LR, axis_name="data")),
    ("resharded", lambda: ckpt.restore_resharded("x", None)),
]


@pytest.mark.parametrize("what,fn", REJECTED, ids=[r[0] for r in REJECTED])
def test_modes_of_later_slices_raise(what, fn):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        fn()


def test_state_placing_functions_need_a_device():
    cfg = get_reduced("granite-8b")
    tcfg = t_get_reduced("granite-8b")
    rt = TRuntime(dtype=torch.float32)
    tree = numpy_tree(init_params(cfg, jax.random.PRNGKey(0)))
    specs = layer_specs(tcfg, seq_len=32)
    with pytest.raises(TypeError):
        init_paged_state(tcfg, 2, rt, num_pages=4, page_size=8, max_len=32)
    with pytest.raises(TypeError):
        init_stack_pool(tcfg, rt, specs, 4, 8)
    with pytest.raises(TypeError):
        params_from_jax(tree, tcfg)
    assert init_stack_pool(tcfg, rt, specs, 4, 8, device="cpu")["k"].device.type == "cpu"
