"""The port's activation stash, tick tables and host-driven pipeline runner
against the JAX package's, on the CPU (the plain version of the K7 codec).

* Codec: the port's ``stash_quantize`` / ``stash_dequantize`` against JAX's
  EAGER call, bitwise (codes, scales, dequantized values) for int8 / fp8 x
  f32 / bf16, at the JAX suite's shapes, a 100-value input that needs
  padding and all-zero blocks. The eager call is the reference because the
  JAX host runner executes the codec eagerly. Against ``jax.jit`` and the
  Pallas kernel in interpret mode (both compile the division differently),
  scales agree within one ulp (the share that differs is printed), codes
  equal for f32 inputs; for bf16 inputs a code may move by one step, only in
  a block whose scale moved (a bf16 value can sit exactly on a rounding tie
  of x / scale, which a one-ulp change of scale breaks).
* Backends: put / get bitwise as JAX's for raw, int8 and fp8; the byte
  accounting equal to JAX's; HostStash's counters equal to JAX's on one
  put / prefetch / poll / get sequence (all but the timing-dependent
  ``overlapped_evictions``); the plan's stash report and the closed forms
  equal to JAX's.
* Schedules: ``tick_table`` arrays and slot counts, and ``simulate``, equal
  to JAX's.
* The toy pipeline of ``tests/test_stash.py`` through both
  ``pipeline_grads_host``, raw / host / int8 / fp8 x 1f1b / gpipe; raw ==
  host bitwise in the port.
* The launcher's ``--pipe`` path on the CPU.
The CUDA kernels K7a / K7b are held against the plain version on the card
(``chip_smoke.py``, and the ``cuda``-marked test below).
"""
import contextlib
import dataclasses
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.core import partitioner as jpartitioner
from repro.core import pipeline as jpipeline
from repro.core import stash as jstash
from repro.kernels.blockwise_quant.ops import stash_dequantize as jstash_dequantize
from repro.kernels.blockwise_quant.ops import stash_quantize as jstash_quantize
from repro.roofline import analysis as janalysis
from repro_torch.configs import get_reduced as t_get_reduced
from repro_torch.core import partitioner, pipeline, stash
from repro_torch.core.stash import SlotSpec
from repro_torch.kernels.blockwise_quant import cuda, ops
from repro_torch.kernels.paged_attention import quant
from repro_torch.launch import train as launch_train
from repro_torch.roofline import analysis

# pytest-xdist runs several workers on one machine: give torch this worker's share
# of the cores (oversubscribed, the torch side runs many times slower)
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

SHAPES = [(3, 7), (257,), (2, 2, 130), (64, 256), (33, 77), (100,)]
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _bits(a) -> np.ndarray:
    """Raw bytes of a JAX array or a tensor, for bitwise comparison."""
    if isinstance(a, torch.Tensor):
        return a.detach().contiguous().view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def mixed(shape, seed, scale_decades=4.0):
    """Normal values whose magnitude varies by ``scale_decades`` decades
    from 256-value block to block (flat order)."""
    rng = np.random.RandomState(seed)
    n = int(np.prod(shape))
    nb = -(-n // 256)
    mag = 10.0 ** rng.uniform(-scale_decades, scale_decades, nb).repeat(256)[:n]
    return (rng.randn(n) * mag).astype(np.float32).reshape(shape)


def both(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a tensor of ``dtype`` (bf16
    rounded once, by JAX, so both sides hold the same bits)."""
    jdt, tdt = DTYPES[dtype]
    xj = jnp.asarray(x, jdt)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)


# -------------------------------------------------------------------- codec
@pytest.mark.parametrize("storage", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_codec_equals_jax_eager_bitwise(shape, dtype, storage):
    xj, xt = both(mixed(shape, seed=len(shape) * 1000 + int(np.prod(shape))), dtype)
    jc, js = jstash_quantize(xj, storage)
    tc, ts = ops.stash_quantize(xt, storage)
    assert tuple(tc.shape) == jc.shape and tuple(ts.shape) == js.shape
    assert tc.dtype == quant._QUANT[storage][0] and ts.dtype == torch.float32
    np.testing.assert_array_equal(_bits(tc), _bits(jc))
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    jd = jstash_dequantize(jc, js, shape, DTYPES[dtype][0])
    td = ops.stash_dequantize(tc, ts, shape, DTYPES[dtype][1])
    assert tuple(td.shape) == shape and td.dtype == DTYPES[dtype][1]
    np.testing.assert_array_equal(_bits(td), _bits(jd))


@pytest.mark.parametrize("storage", ["int8", "fp8"])
def test_codec_zero_blocks_and_padding(storage):
    """100 zeros pad to one block of scale 0 and come back as zeros; a zero
    block beside a nonzero one keeps scale 0, as in JAX."""
    x = np.zeros(600, np.float32)
    x[300:] = np.random.RandomState(1).randn(300)
    for vals in (np.zeros(100, np.float32), x):
        jc, js = jstash_quantize(jnp.asarray(vals), storage)
        tc, ts = ops.stash_quantize(torch.from_numpy(vals), storage)
        np.testing.assert_array_equal(_bits(tc), _bits(jc))
        np.testing.assert_array_equal(_bits(ts), _bits(js))
        back = ops.stash_dequantize(tc, ts, vals.shape, torch.float32)
        assert float(back[:256].abs().max()) == 0.0 and float(ts[0]) == 0.0
    assert tc.shape == (3, 256)


@pytest.mark.parametrize("storage", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_codec_against_jitted_and_pallas_interpret(dtype, storage):
    """2**16 values of mixed scale: JAX's jitted codec and its Pallas kernel
    (interpret mode, as tests/test_kernels_quant.py runs it) against the
    port's plain version."""
    xj, xt = both(mixed((1 << 16,), seed=3), dtype)
    tc, ts = ops.stash_quantize(xt, storage)
    tcodes = tc.view(torch.uint8).numpy().astype(np.int32)
    tval = tc.float().numpy()
    for name, kw in (("jit", {}), ("pallas", {"backend": "pallas"})):
        jc, js = jax.jit(lambda v, kw=kw: jstash_quantize(v, storage, **kw))(xj)
        ulps = np.abs(np.asarray(js).view(np.int32).astype(np.int64)
                      - ts.numpy().view(np.int32).astype(np.int64))
        moved = ulps > 0
        print(f"{name} {dtype} {storage}: scales differing from the eager "
              f"codec's {moved.mean():.4f} (max {ulps.max()} ulp)")
        assert ulps.max() <= 1
        diff = _bits(jc).astype(np.int32) != tcodes
        if dtype == "f32":
            np.testing.assert_array_equal(_bits(jc), _bits(tc))
            continue
        # a code moves only in a block whose scale moved, and by one step of
        # the storage type (adjacent int8 values; adjacent fp8 encodings)
        assert not (diff.any(axis=1) & ~moved).any()
        if storage == "int8":
            assert np.all(np.abs(np.asarray(jc).astype(np.float32) - tval)[diff] <= 1)
        else:
            assert np.all(np.abs(_bits(jc).astype(np.int32) - tcodes)[diff] <= 1)
        print(f"  codes differing {diff.mean():.6f}")


def kernel_int8_code(q: torch.Tensor) -> torch.Tensor:
    """K7a's int8 rounding (``csrc/blockwise_quant.cu::int8_code``) in plain
    torch: clamp to +-127, add 1.5 * 2^23 in f32 (round to nearest even), and
    read the code from byte 0 of the sum's bits."""
    t = torch.clamp(q.float(), -127.0, 127.0) + 12582912.0
    return (t.view(torch.int32) & 0xFF).to(torch.uint8).view(torch.int8)


@pytest.mark.parametrize("inputs", ["halves", "seeded"])
def test_kernel_int8_rounding_equals_torch_round(inputs):
    """Every multiple of 0.5 in [-127, 127] (each tie, both signs), and 10^5
    seeded quotients in [-130, 130], against the plain version's
    ``torch.round`` (half to even) after its clamp."""
    if inputs == "halves":
        q = torch.arange(-254, 255, dtype=torch.float32) / 2
    else:
        q = torch.tensor(np.random.RandomState(11).uniform(-130, 130, 100_000),
                         dtype=torch.float32)
    want = torch.round(torch.clamp(q, -127.0, 127.0)).to(torch.int8)
    assert torch.equal(kernel_int8_code(q), want)


def test_cpu_route_never_touches_cuda(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("CUDA path taken for a CPU tensor")

    for name in ("stash_quantize_cuda", "stash_dequantize_cuda", "library"):
        monkeypatch.setattr(cuda, name, refuse)
    before = dict(cuda.LAUNCHES)
    c, s = ops.stash_quantize(torch.randn(3, 300, dtype=torch.bfloat16), "fp8")
    ops.stash_dequantize(c, s, (3, 300), torch.bfloat16)
    assert cuda.LAUNCHES == before


def test_cuda_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda.stash_quantize_cuda(torch.zeros(256), "int8")
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda.stash_dequantize_cuda(torch.zeros(1, 256, dtype=torch.int8), torch.zeros(1),
                                   torch.float32)


@pytest.mark.cuda
def test_cuda_stash_codec_matches_plain_bitwise_on_the_card():
    """On an H100: K7a / K7b against the plain version, bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with python3 chip_smoke.py")
    for dtype in (torch.float32, torch.bfloat16):
        for storage in ("int8", "fp8"):
            x = torch.from_numpy(mixed((3, 4096), seed=9)).to("cuda", dtype)
            c, s = ops.stash_quantize(x, storage)
            pc, ps = quant.kv_quantize(x.reshape(-1, 256), quant._QUANT[storage][0])
            assert torch.equal(c.view(torch.uint8), pc.view(torch.uint8))
            assert torch.equal(s, ps)
            d = ops.stash_dequantize(c, s, x.shape, dtype)
            assert torch.equal(d.view(-1), quant.kv_dequantize(c, s, dtype).view(-1))


# ----------------------------------------------------------------- backends
BACKENDS = ["raw", "int8", "fp8"]


@pytest.mark.parametrize("name", BACKENDS)
def test_put_get_equal_jax_bitwise(name):
    shape = (2, 5, 33)
    xj, xt = both(mixed(shape, seed=7, scale_decades=1.0), "bf16")
    jb, tb = jstash.get_backend(name), stash.get_backend(name)
    jstruct = jax.ShapeDtypeStruct(shape, jnp.bfloat16)
    spec = SlotSpec(shape, torch.bfloat16, torch.device("cpu"))
    jstate = jb.put(jb.init(3, jstruct), 1, xj)
    tstate = tb.put(tb.init(3, spec), 1, xt)
    np.testing.assert_array_equal(_bits(tb.get(tstate, 1, spec)), _bits(jb.get(jstate, 1, jstruct)))
    np.testing.assert_array_equal(_bits(tb.roundtrip(xt)), _bits(jb.roundtrip(xj)))
    if name != "raw":      # the state itself: codes and scales of every slot
        for k in ("codes", "scales"):
            np.testing.assert_array_equal(_bits(tstate[k]), _bits(jstate[k]))


def test_roundtrip_is_straight_through():
    x = torch.randn(4, 300, requires_grad=True)
    y = stash.get_backend("int8").roundtrip(x)
    g = torch.randn(4, 300)
    (dx,) = torch.autograd.grad(y, x, g)
    assert torch.equal(dx, g) and not torch.equal(y.detach(), x.detach())


SPECS = [((8192,), "bf16"), ((100,), "f32"), ((2, 5, 33), "bf16"), ((1, 64, 128), "f32")]


@pytest.mark.parametrize("name", ["raw", "int8", "fp8", "host"])
def test_byte_accounting_equals_jax(name):
    for shape, dtype in SPECS:
        jdt, tdt = DTYPES[dtype]
        jstruct = jax.ShapeDtypeStruct(shape, jdt)
        spec = SlotSpec(shape, tdt, torch.device("cpu"))
        jb, tb = jstash.get_backend(name, host_window=2), stash.get_backend(name, host_window=2)
        assert tb.slot_bytes(spec) == jb.slot_bytes(jstruct)
        for n in (1, 3, 5):
            assert tb.device_bytes(n, spec) == jb.device_bytes(n, jstruct)
            assert tb.host_bytes(n, spec) == jb.host_bytes(n, jstruct)
            assert tb.state_bytes(n, spec) == jb.state_bytes(n, jstruct)
        if name in ("raw", "int8", "fp8"):      # exact: what init allocates
            state = tb.init(3, spec)
            tensors = [state] if name == "raw" else list(state.values())
            assert sum(t.nbytes for t in tensors) == tb.state_bytes(3, spec)


def test_host_stash_counters_equal_jax():
    """One put / prefetch / poll / get sequence, window 2, with slot reuse:
    every value comes back bitwise and every counter but the timing-dependent
    ``overlapped_evictions`` equals JAX's."""
    rng = np.random.RandomState(5)
    vals = [rng.randn(3, 40).astype(np.float32) for _ in range(6)]
    jb, tb = jstash.HostStash(window=2), stash.HostStash(window=2)
    js, ts = jb.init(5, None), tb.init(5, None)
    script = [("put", 0, 0), ("put", 1, 1), ("put", 2, 2), ("put", 3, 3),
              ("prefetch", 0), ("poll",), ("get", 0), ("get", 3), ("get", 1),
              ("put", 0, 4), ("put", 4, 5), ("prefetch", 2), ("get", 2),
              ("poll",), ("prefetch", 1), ("get", 1), ("get", 0), ("get", 4)]
    for op, *args in script:
        if op == "put":
            js = jb.put(js, args[0], jnp.asarray(vals[args[1]]))
            ts = tb.put(ts, args[0], torch.from_numpy(vals[args[1]].copy()))
        elif op == "get":
            np.testing.assert_array_equal(tb.get(ts, args[0], None).numpy(),
                                          np.asarray(jb.get(js, args[0], None)))
        elif op == "prefetch":
            jb.prefetch(js, args[0])
            tb.prefetch(ts, args[0])
        else:
            jb.poll(js)
            tb.poll(ts)
    want, got = jb.stats(), tb.stats()
    want.pop("overlapped_evictions")
    got.pop("overlapped_evictions")
    assert got == want
    assert got["evictions"] > 0 and got["stalled_gets"] > 0 and got["prefetch_hits"] > 0


PLANS = [
    dict(pp=2, microbatches=4),
    dict(pp=2, microbatches=4, stash="fp8"),
    dict(pp=2, microbatches=4, stash="int8", stash_cot=True),
    dict(pp=2, microbatches=4, stash="host", schedule="gpipe"),
    dict(pp=4, microbatches=8, stash="int8", remat="full"),
]


@pytest.mark.parametrize("kw", PLANS, ids=[str(i) for i in range(len(PLANS))])
def test_plan_validation_and_stash_report_equal_jax(kw):
    jcfg = get_reduced("granite-8b", n_layers=4)
    tcfg = t_get_reduced("granite-8b", n_layers=4)
    args = dict(global_batch=16, seq_len=64, itemsize=2)
    jplan = jpartitioner.ParallelPlan(**kw).validate(jcfg)
    tplan = partitioner.ParallelPlan(**kw).validate(tcfg)
    assert tplan.describe() == jplan.describe()
    assert tplan.stash_report(tcfg, **args) == jplan.stash_report(jcfg, **args)
    budget = jplan.stash_report(jcfg, **args)["total_bytes"]
    for b in (budget, budget - 1):
        try:
            jplan.validate(jcfg, act_budget=b, **args)
            jok = True
        except ValueError:
            jok = False
        if jok:
            tplan.validate(tcfg, act_budget=b, **args)
        else:
            with pytest.raises(ValueError, match="exceeds budget"):
                tplan.validate(tcfg, act_budget=b, **args)


def test_plan_rejections_follow_jax():
    tcfg = t_get_reduced("granite-8b", n_layers=4)
    for kw in (dict(dp=2, pp=2, stash="host"), dict(pp=3), dict(pp=2, stash="raw",
               stash_cot=True), dict(pp=2, schedule="interleaved"), dict(pp=2, stash="zstd")):
        with pytest.raises(ValueError):
            partitioner.ParallelPlan(**kw).validate(tcfg)
    gemma = t_get_reduced("gemma3-1b")
    with pytest.raises(ValueError, match="mixed mixer kinds"):
        partitioner.ParallelPlan(pp=2).validate(gemma)


def test_closed_forms_equal_jax():
    for n in (100, 8192, 2048 * 4096):
        for s in ("raw", "int8", "fp8", "host"):
            for isz in (2, 4):
                assert (analysis.stash_bytes_per_slot(n, s, isz)
                        == janalysis.stash_bytes_per_slot(n, s, isz))
                assert (analysis.predicted_stash_capacity_factor(n, s, isz)
                        == janalysis.predicted_stash_capacity_factor(n, s, isz))
                for cot in ("raw", "fp8"):
                    assert (analysis.predicted_pipeline_stash_bytes(n, 4, 1, s, isz, cot_stash=cot)
                            == janalysis.predicted_pipeline_stash_bytes(n, 4, 1, s, isz,
                                                                        cot_stash=cot))
                assert (analysis.predicted_stash_host_bytes(n, 5, s, isz)
                        == janalysis.predicted_stash_host_bytes(n, 5, s, isz))
        for remat in ("none", "full"):
            assert (analysis.predicted_stage_transient_bytes(n, 3, remat, 2)
                    == janalysis.predicted_stage_transient_bytes(n, 3, remat, 2))


# ---------------------------------------------------------------- schedules
TABLE_CASES = [(s, P, M) for s in ("1f1b", "gpipe") for P, M in ((2, 2), (2, 4), (4, 8), (3, 5))]


@pytest.mark.parametrize("schedule,P,M", TABLE_CASES, ids=[f"{s}-{P}x{M}" for s, P, M in TABLE_CASES])
def test_tick_tables_and_simulator_equal_jax(schedule, P, M):
    jt, tt = jpipeline.tick_table(schedule, P, M), pipeline.tick_table(schedule, P, M)
    for f in dataclasses.fields(jt):
        a, b = getattr(tt, f.name), getattr(jt, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert tt.bubble_fraction == jt.bubble_fraction
    for name in pipeline.SCHEDULES:
        assert (dataclasses.asdict(pipeline.simulate(name, P, M))
                == dataclasses.asdict(jpipeline.simulate(name, P, M))), name


def test_mesh_runners_raise():
    for fn in (pipeline.pipeline_grads, pipeline.pipeline_apply):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 7"):
            fn()


# --------------------------------------------------------------- toy runner
def compiled(fn, *args):
    """``fn`` jitted for ``args``' shapes, with XLA's backend optimisation off
    (half the compile time; no fusion, so no contraction into FMAs)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


P_TOY, M_TOY, L_TOY, D_TOY = 2, 4, 4, 6


def toy_inputs(seed=0):
    """tests/test_stash.py's _toy_pipeline draws, as numpy."""
    rng = np.random.RandomState(seed)
    w = rng.randn(L_TOY, D_TOY, D_TOY).astype(np.float32) * 0.3
    emb = rng.randn(D_TOY, D_TOY).astype(np.float32) * 0.3
    mbs = rng.randn(M_TOY, 2, D_TOY).astype(np.float32)
    return w, emb, mbs


def port_toy(backend, schedule, lookahead=2, seed=0):
    w, emb, mbs = toy_inputs(seed)
    layers = [torch.from_numpy(w[i].copy()).requires_grad_(True) for i in range(L_TOY)]
    shared = {"emb": torch.from_numpy(emb.copy()).requires_grad_(True)}

    def first_fn(sh, mb):
        return mb @ sh["emb"]

    def stage_fn(ws, x):
        for wi in ws:
            x = torch.tanh(x @ wi)
        return x, torch.zeros(())

    def last_fn(sh, y, mb):
        loss = torch.sum((y - mb) ** 2)
        return loss, {"xent": loss}

    return pipeline.pipeline_grads_host(
        first_fn, stage_fn, last_fn, layers, shared, torch.from_numpy(mbs),
        table=pipeline.tick_table(schedule, P_TOY, M_TOY),
        x_struct=SlotSpec((2, D_TOY), torch.float32, torch.device("cpu")),
        metrics_struct=("xent",), stash=backend, lookahead=lookahead,
    )


@pytest.fixture(scope="module")
def jax_toy():
    """JAX's host runner on the toy, once per codec, compiled as one program
    with XLA's backend optimisation off (eagerly it compiles each stage op
    anew, ~4 s a run; compiled, the codec's scales may sit an ulp from the
    eager codec's, inside TOY_TOL). JAX's raw and host
    stashes give the same bits (tests/test_stash.py), and so do its 1f1b and
    gpipe tables (each stage runs its backward ops in microbatch order under
    both), so one run per codec serves every case."""
    from test_stash import _toy_pipeline

    cache = {}

    def run(name):
        codec = "raw" if name == "host" else name
        if codec not in cache:
            stage_params, shared, mbs, first_fn, stage_fn, last_fn = _toy_pipeline(
                P_TOY, M_TOY, L_TOY, D_TOY)
            run_host = compiled(lambda sp, sh, mb: jpipeline.pipeline_grads_host(
                first_fn, stage_fn, last_fn, sp, sh, mb,
                table=jpipeline.tick_table("1f1b", P_TOY, M_TOY),
                x_struct=jax.ShapeDtypeStruct((2, D_TOY), jnp.float32),
                metrics_struct={"xent": jax.ShapeDtypeStruct((), jnp.float32)},
                stash=jstash.get_backend(codec),
            ), stage_params, shared, mbs)
            loss, metrics, gstack, gshared = run_host(stage_params, shared, mbs)
            cache[codec] = (float(loss), float(metrics["xent"]), np.asarray(gstack["w"]),
                            np.asarray(gshared["emb"]))
        return cache[codec]

    return run


# f32 throughout. raw / host: the same ops, summed in another order, 1e-5.
# int8 / fp8: both sides quantize values that may differ by an ulp, so a code
# at a rounding edge can take its neighbour: one code step is 1/127 (int8)
# or up to 1/16 (fp8, 3 mantissa bits) of its block's absmax, hence 1e-3 and
# 2e-2 relative, against max|grad| for the grads.
TOY_TOL = {"raw": 1e-5, "host": 1e-5, "int8": 1e-3, "fp8": 2e-2}


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
@pytest.mark.parametrize("name", ["raw", "host", "int8", "fp8"])
def test_toy_runner_matches_jax(jax_toy, name, schedule):
    jl, jx, jgw, jge = jax_toy(name)
    backend = stash.get_backend(name, host_window=1)
    loss, metrics, gstack, gshared = port_toy(backend, schedule)
    tol = TOY_TOL[name]
    np.testing.assert_allclose(float(loss), jl, rtol=tol)
    np.testing.assert_allclose(float(metrics["xent"]), jx, rtol=tol)
    gw = torch.stack(gstack).numpy()
    for got, want in ((gw, jgw), (gshared[0].numpy(), jge)):
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())
    if name == "host":
        st = backend.stats()
        assert st["evictions"] > 0 and st["host_hits"] > 0


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
def test_toy_runner_raw_equals_host_bitwise(schedule):
    outs = {}
    for name, la in (("raw", 2), ("host", 0), ("host", 3)):
        loss, metrics, gstack, gshared = port_toy(stash.get_backend(name, host_window=1),
                                                  schedule, lookahead=la)
        outs[name, la] = [loss, metrics["xent"], *gstack, *gshared]
    for key in (("host", 0), ("host", 3)):
        for a, b in zip(outs[key], outs["raw", 2]):
            assert torch.equal(a, b), key


def test_toy_runner_stash_perturbs_like_a_codec():
    """int8 moves the grads off raw's by a real but small amount."""
    raw = port_toy(stash.get_backend("raw"), "1f1b")
    q = port_toy(stash.get_backend("int8"), "1f1b")
    gr, gq = torch.stack(raw[2]), torch.stack(q[2])
    rel = float((gr - gq).norm() / gr.norm())
    assert 0 < rel < 0.05, rel


# ----------------------------------------------------------------- launcher
def test_launcher_trains_the_pipeline_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_train.main(["--arch", "granite-8b", "--reduced", "--device", "cpu",
                           "--steps", "1", "--batch", "4", "--seq", "32", "--pipe", "2",
                           "--microbatches", "2", "--stash", "host", "--schedule", "gpipe"])
    text = out.getvalue()
    assert "train main OK" in text and "pp=2 M=2 schedule=gpipe" in text, text
    assert "stash=host bytes/slot=" in text and "host overlap: stall fraction=" in text, text


def test_launcher_plan_auto_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 7"):
        launch_train.main(["--arch", "granite-8b", "--device", "cpu", "--plan", "auto"])


@pytest.mark.parametrize("flags", [["--stash", "int8"], ["--stash", "host"], ["--stash-cot"],
                                   ["--microbatches", "4"], ["--schedule", "gpipe"]])
def test_launcher_refuses_pipeline_flags_without_pipe(flags, capsys):
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "granite-8b", "--reduced", "--device", "cpu"] + flags)
    assert "give --pipe P" in capsys.readouterr().err
