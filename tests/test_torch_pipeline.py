"""The port's pipeline training slice as a whole against the JAX package's,
on the CPU.

A small-width granite-8b (4 layers: 2 stages of 2, d 64, 4 query heads over
2 kv heads of hd 16, vocabulary 256), registered for JAX as
tests/test_train_stash.py registers its config, trains 2 steps in f32
through each package's ``build_train_pipeline_host`` (1F1B, M = 4
microbatches of 1 x 32) from the same initial state (carried across by
``state_from_jax``) and the same batches, with the raw and the int8 stash.
Compared after each step: the loss, and the params.

JAX's step is compiled once here, with XLA's backend optimisation off:
unjitted, as its launcher runs it, it compiles some 330 small programs per
step (~30 s a step on one CPU core), jitted one program (~19 s to compile,
~9 s unoptimised). Compiled, JAX's codec may round a scale one ulp away from
its eager codec (tests/test_torch_stash.py measures how often), which the
int8 tolerances below cover; the port's codec equals the eager one bitwise.
"""
import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.registry as jregistry
from repro.checkpoint.ckpt import _flatten
from repro.configs import ShapeSpec, get_reduced
from repro.core.partitioner import ParallelPlan as JParallelPlan
from repro.data.pipeline import DataPipeline as JDataPipeline
from repro.launch.train import build_train_pipeline_host as jbuild
from repro.optim import get as jget
from repro.train.loop import TrainConfig as JTrainConfig
from repro.train.loop import make_state as jmake_state
from repro_torch.checkpoint import state_from_jax, state_to_numpy
from repro_torch.configs import get_reduced as t_get_reduced
from repro_torch.core.partitioner import ParallelPlan
from repro_torch.launch.train import build_train_pipeline_host
from repro_torch.train import TrainConfig, plan_fields

# pytest-xdist runs several workers on one machine: give torch this worker's share
# of the cores (oversubscribed, the torch side runs many times slower)
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

SMALL = dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
             vocab_size=256)
NAME = "granite-8b-pipe-small"     # not granite-8b-reduced, which other tests use
B, SEQ, M, STEPS, LR = 4, 32, 4, 2, 1e-3


def compiled(fn, *args):
    """``fn`` jitted for ``args``' shapes, with XLA's backend optimisation off
    (half the compile time; no fusion, so no contraction into FMAs)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def batches():
    cfg = replace(get_reduced("granite-8b", **SMALL), name=NAME)
    data = JDataPipeline(cfg, B, SEQ, seed=0)
    try:
        return [{k: np.asarray(v) for k, v in next(data).items()} for _ in range(STEPS)]
    finally:
        data.close()


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's pipeline steps per stash, run once: the initial state and, per
    step, (loss, flat params)."""
    cfg = replace(get_reduced("granite-8b", **SMALL), name=NAME)
    # JAX's builder looks the config up by name; taken out again at the end
    jregistry.ARCHITECTURES[cfg.name] = cfg
    cache = {}

    def run(stash):
        if stash not in cache:
            tc = JTrainConfig(precision="f32", lr=LR, log_every=1)
            plan = JParallelPlan(pp=2, microbatches=M, stash=stash)
            step, _, _ = jbuild(cfg.name, plan, tc, ShapeSpec("t", SEQ, B, "train"))
            state = jmake_state(cfg, jget("adamw", LR), tc, seed=0)
            init = jax.tree.map(np.asarray, state)
            out = []
            for b in batches():
                jb = {k: jnp.asarray(v) for k, v in b.items()}
                if not out:
                    step = compiled(step, state, jb)
                state, m = step(state, jb)
                out.append((float(m["loss"]),
                            _flatten(jax.tree.map(np.asarray, state["params"]))))
            cache[stash] = (init, out)
        return cache[stash]

    yield run
    del jregistry.ARCHITECTURES[cfg.name]


# f32 on both sides. Loss: the same ops summed in another order, 1e-5 (raw);
# with int8 the codes of values that differ by an ulp can take the
# neighbouring code at a bin edge (1/127 of the block's absmax), so the
# losses agree to 1e-4. Params: Adam moves every element by about lr at
# step 1 whatever its gradient, so an element whose gradient sits at the
# roundoff level (or, with int8, whose gradient a flipped code moved) may
# differ by up to 2 * lr per step: no element may differ by more than
# 2 * STEPS * lr, and in norm the params agree to PARAM_REL of theirs.
LOSS_RTOL = {"raw": 1e-5, "int8": 1e-4}
PARAM_REL = {"raw": 1e-4, "int8": 1e-3}


@pytest.mark.parametrize("stash", ["raw", "int8"])
def test_pipeline_steps_match_jax(jax_runs, stash):
    init, want = jax_runs(stash)
    tcfg = replace(t_get_reduced("granite-8b", **SMALL), name=NAME)
    plan = ParallelPlan(pp=2, microbatches=M, stash=stash)
    tc = TrainConfig(precision="f32", lr=LR, log_every=1, **plan_fields(plan))
    step, backend = build_train_pipeline_host(tcfg, plan, tc)
    state = state_from_jax(init, tcfg, device="cpu")
    for i, (b, (jloss, jparams)) in enumerate(zip(batches(), want)):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(m["loss"]), jloss, rtol=LOSS_RTOL[stash])
        got = _flatten(state_to_numpy(state))
        bound = 2 * (i + 1) * LR
        for k, w in jparams.items():
            g = got["params/" + k]
            err = np.abs(g - w)
            rel = np.linalg.norm(err) / np.linalg.norm(w)
            assert rel <= PARAM_REL[stash], (i, k, rel)
            assert err.max() <= bound, (i, k, err.max())
    assert int(state["step"]) == STEPS


def test_pipeline_loss_equals_plain_step_at_raw():
    """With the raw stash the first pipeline step's loss is the plain
    single-device step's (the mean of equal-size microbatch means), and
    gpipe gives 1f1b's bits."""
    from repro_torch.models import Runtime, loss_fn
    from repro_torch.optim import get
    from repro_torch.train import make_state

    tcfg = replace(t_get_reduced("granite-8b", **SMALL), name=NAME)
    b = {k: torch.from_numpy(v) for k, v in batches()[0].items()}
    losses = {}
    for schedule in ("1f1b", "gpipe"):
        plan = ParallelPlan(pp=2, microbatches=M, schedule=schedule)
        tc = TrainConfig(precision="f32", lr=LR, **plan_fields(plan))
        step, _ = build_train_pipeline_host(tcfg, plan, tc)
        state = make_state(tcfg, get("adamw", LR), tc, seed=1, device="cpu")
        _, m = step(state, b)
        losses[schedule] = float(m["loss"])
    state = make_state(tcfg, get("adamw", LR), TrainConfig(), seed=1, device="cpu")
    with torch.no_grad():
        per_mb = [float(loss_fn(tcfg, state["params"], {k: v[i:i + 1] for k, v in b.items()},
                                Runtime(dtype=torch.float32))[0]) for i in range(M)]
    assert losses["1f1b"] == losses["gpipe"]
    np.testing.assert_allclose(losses["1f1b"], np.mean(per_mb), rtol=1e-6)


@pytest.mark.parametrize("field", ["pipe", "microbatches", "schedule", "stash", "stash_cot",
                                   "remat"])
def test_pipeline_refuses_a_config_that_disagrees_with_the_plan(field):
    """The plan is the one source of the pipeline's settings: a TrainConfig
    whose pipeline field differs from it is refused, not ignored."""
    tcfg = replace(t_get_reduced("granite-8b", **SMALL), name=NAME)
    plan = ParallelPlan(pp=2, microbatches=M, stash="int8")
    other = {"pipe": 4, "microbatches": 2, "schedule": "gpipe", "stash": "raw",
             "stash_cot": True, "remat": "full"}[field]
    tc = replace(TrainConfig(precision="f32", **plan_fields(plan)), **{field: other})
    with pytest.raises(ValueError, match=field):
        build_train_pipeline_host(tcfg, plan, tc)
    step, backend = build_train_pipeline_host(tcfg, plan)     # tc from the plan
    assert backend.name == "int8"
