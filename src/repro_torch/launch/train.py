"""Training launcher of the PyTorch port: the single-device training step.

    # gemma3-1b at full width and depth on the card, bf16 over f32 masters
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b --full \
        --precision bf16 --batch 4 --seq 2048 --steps 10 --fused-backward

    # reduced config on the CPU (plain versions of the kernels)
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \
        --reduced --device cpu --steps 3 --batch 2 --seq 128

    # 8-bit Adam (the K8 codec on the card; adam4bit, onebit_adam likewise)
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \
        --reduced --device cpu --steps 3 --batch 2 --seq 128 --optimizer adam8bit

    # the pipeline: 2 stages, 4 microbatches, 1F1B, int8 activation stash
    # (K7 on the card); --stash raw|fp8|host, --schedule gpipe likewise
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \
        --reduced --device cpu --steps 3 --batch 8 --seq 64 --pipe 2 \
        --microbatches 4 --stash int8

Counterpart of the single-device path of ``repro.launch.train``: random
weights from ``--seed``, batches from ``data.DataPipeline(seed=--seed)``,
``train.loop.fit`` with AdamW (or ``--optimizer``). It prints each step's
loss, step time, tokens/s, the peak device memory, the optimizer state's
bytes beside AdamW's, and the launches of the flash-attention (K1, K2),
RMSNorm (K3, K4) and blockwise-quantization (K8, K7) kernels. It runs on
CUDA unless ``--device cpu`` is given.

``--pipe P`` trains through ``build_train_pipeline_host``: the 1F1B / GPipe
tick tables over ``--microbatches`` per step, each stage's input kept in the
``--stash`` backend, the stage recomputed in its backward. On one card every
pipeline plan runs on this host-driven runner: the JAX launcher sends int8 /
fp8 plans to its P-device ``shard_map`` runner, which waits for
``torch.distributed`` (ROADMAP queue 1 item 7), while JAX's own
``build_train_pipeline_host`` takes them as this one does. The launcher
prints JAX's stash-report line, and for ``--stash host`` its counters and
overlap line. ``--plan auto`` and the JAX launcher's mesh and ZeRO flags
belong to later slices.
"""
from __future__ import annotations

import argparse
import time

import torch


OPTIMIZERS = ("adamw", "adam", "sgd", "lars", "lamb", "adam8bit", "adam4bit", "onebit_adam")


def _counted():
    from repro_torch.kernels.blockwise_quant import cuda as bq
    from repro_torch.kernels.flash_attention import cuda as fa
    from repro_torch.kernels.rmsnorm import cuda as rn

    return fa, rn, bq


def kernel_launches() -> dict:
    """The K1-K4, K7 and K8 launch counters of this process."""
    return {k: v for m in _counted() for k, v in m.LAUNCHES.items()}


def reset_kernel_launches() -> None:
    for m in _counted():
        m.reset_launches()


def build_train_pipeline_host(arch, plan, tc=None, host_window: int = 2,
                              lookahead: int = 2):
    """The single-device pipeline step for ``plan`` (counterpart of the JAX
    launcher's function of the same name): ``pipeline_grads_host`` over the
    plan's tick table, with the loss seed ``scale / M``, then the grads in
    ``LM.parameters()`` order into ``train.loop.finish_step``. ``arch`` is a
    config or its name. Returns (step, stash backend); the backend's
    ``stats()`` are HostStash's counters. The state is ``train.make_state``'s
    and batches are those of ``fit``, so JAX's ShapeDtypeStructs (and its
    ``shape`` argument) have no counterpart. ``host_window`` sizes a host
    stash's device window; ``lookahead`` is how many ticks ahead its
    prefetch reads the table (0 = eager; the result is the same bits).

    The plan decides the pipeline: ``tc``'s pipeline fields and ``remat``
    must equal it (``train.plan_fields``), else this raises; ``tc`` defaults
    to bf16 with the plan's fields."""
    from repro_torch.configs import ArchConfig, get_config
    from repro_torch.core.pipeline import parameters_of, pipeline_grads_host, tick_table
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.core.stash import SlotSpec, get_backend
    from repro_torch.models import Runtime, pipeline_fns, pipeline_shared
    from repro_torch.optim import get as get_opt
    from repro_torch.train import TrainConfig, finish_step, plan_fields

    cfg = arch if isinstance(arch, ArchConfig) else get_config(arch)
    fields = plan_fields(plan)
    tc = tc or TrainConfig(precision="bf16", **fields)
    differ = {k: (getattr(tc, k), v) for k, v in fields.items() if getattr(tc, k) != v}
    if differ:
        raise ValueError(f"TrainConfig disagrees with the plan on {differ} "
                         "(config, plan): build it with train.plan_fields(plan)")
    plan.validate(cfg)
    if (plan.dp, plan.tp) != (1, 1):
        raise NotImplementedError(
            f"dp={plan.dp}, tp={plan.tp}: the pipeline across devices is ROADMAP "
            "queue 1 item 7; one card runs dp = tp = 1"
        )
    opt = get_opt(tc.optimizer, tc.lr)
    policy = getattr(PrecisionPolicy, tc.precision)()
    rt = Runtime(dtype=policy.compute_dtype, remat=plan.remat)
    table = tick_table(plan.schedule, plan.pp, plan.microbatches)
    first_fn, stage_fn, last_fn = pipeline_fns(cfg, rt)
    M = plan.microbatches
    backend = get_backend(plan.stash, host_window=host_window, cotangents=plan.stash_cot)

    def step(state, batch):
        lm = state["params"]
        layers, shared = list(lm.stack.layers), pipeline_shared(lm)
        B, seq = batch["tokens"].shape
        if B % M:
            raise ValueError(f"batch {B} not divisible into {M} microbatches")
        mbs = {k: v.reshape((M, B // M) + tuple(v.shape[1:])) for k, v in batch.items()}
        x_struct = SlotSpec((B // M, seq, cfg.d_model), rt.dtype, batch["tokens"].device)
        seed = state["scale"]["scale"] / M
        loss_sum, msum, stack_g, shared_g = pipeline_grads_host(
            first_fn, stage_fn, last_fn, layers, shared, mbs, table=table,
            x_struct=x_struct, metrics_struct=("xent", "z_loss"), seed=seed,
            stash=backend, lookahead=lookahead,
        )
        by_param = dict(zip(map(id, parameters_of(layers) + parameters_of(shared)),
                            stack_g + shared_g))
        grads = [by_param[id(p)] for p in lm.parameters()]
        loss, xent, zl = loss_sum / M, msum["xent"] / M, msum["z_loss"] / M
        aux = ((loss - xent - zl) / cfg.router_aux_coef if cfg.router_aux_coef
               else torch.zeros((), dtype=torch.float32, device=loss.device))
        metrics = {"loss": loss, "xent": xent, "z_loss": zl, "aux": aux}
        return finish_step(state, grads, metrics, tc, policy, opt)

    return step, backend


def print_stash_report(plan, cfg, batch: int, seq: int, itemsize: int, backend) -> None:
    """The JAX launcher's stash line, and for a host stash its counters and
    overlap line."""
    rep = plan.stash_report(cfg, global_batch=batch, seq_len=seq, itemsize=itemsize)
    print(f"stash={rep['backend']} bytes/slot={rep['bytes_per_slot']} "
          f"(raw {rep['raw_bytes_per_slot']}) "
          f"act high-water={rep['n_act_slots']} slots "
          f"device bytes={rep['device_bytes']} "
          f"host bytes={rep['host_bytes']} "
          f"transient bytes={rep['transient_bytes']} (remat={rep['remat']}) "
          f"capacity={rep['capacity_factor']:.2f}x raw")
    if hasattr(backend, "stats"):
        stats = backend.stats()
        host_hits = max(stats.get("host_hits", 0), 1)
        print(f"host stash stats: {stats}")
        print(f"host overlap: stall fraction="
              f"{stats.get('stalled_gets', 0) / host_hits:.2f} "
              f"prefetch hit rate="
              f"{stats.get('prefetch_hits', 0) / host_hits:.2f} "
              f"(of {stats.get('host_hits', 0)} off-window gets)")


def optimizer_state_bytes(state) -> tuple:
    """(bytes of the optimizer state's tensors, bytes of AdamW's f32 m and v
    for the same params)."""
    from repro_torch.optim import state_bytes

    n = sum(p.numel() for p in state["params"].parameters())
    return int(state_bytes(state["opt"])), 2 * 4 * n


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--precision", default="f32", choices=("f32", "bf16", "fp16"))
    ap.add_argument("--remat", default="none", choices=("none", "full", "dots"))
    ap.add_argument("--fused-backward", action="store_true",
                    help="the vocab-chunked CE head (never holds (B, S, V) logits)")
    ap.add_argument("--optimizer", default="adamw", choices=OPTIMIZERS)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the hand kernels) or cpu")
    ap.add_argument("--pipe", type=int, default=1,
                    help="pipeline stages; > 1 trains through the host-driven runner")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="microbatches per step (default 2 * pipe)")
    ap.add_argument("--schedule", default="1f1b", choices=("1f1b", "gpipe"))
    ap.add_argument("--plan", default="", choices=("", "auto"))
    ap.add_argument("--stash", default="raw", choices=("raw", "int8", "fp8", "host"),
                    help="pipeline activation-slot storage (core.stash)")
    ap.add_argument("--stash-cot", action="store_true",
                    help="pass the pipeline's cotangents through the codec too (int8/fp8)")
    ap.add_argument("--stash-lookahead", type=int, default=2,
                    help="host stash prefetch window in ticks (0 = eager)")
    ap.add_argument("--act-budget-mb", type=float, default=0.0,
                    help="per-stage activation-state budget in MiB, checked by the plan")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("CUDA is not available; pass --device cpu to run on the CPU")

    from repro_torch.configs import ASSIGNED, get_config, get_reduced
    from repro_torch.data import DataPipeline
    from repro_torch.optim import get as get_opt
    from repro_torch.train import TrainConfig, fit, make_state, plan_fields

    if args.arch not in ASSIGNED:
        ap.error(f"--arch must be one of {ASSIGNED}")
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.plan == "auto":
        raise NotImplementedError("--plan auto (the partition search and auto_plan) "
                                  "is ROADMAP queue 1 item 7, 'the pipeline'")
    if args.pipe <= 1 and (args.stash != "raw" or args.stash_cot or args.microbatches
                           or args.schedule != "1f1b"):
        ap.error("--stash, --stash-cot, --microbatches and --schedule configure the "
                 "pipeline trainer: give --pipe P")
    plan = None
    if args.pipe > 1:
        from repro_torch.core.partitioner import ParallelPlan
        from repro_torch.core.precision import PrecisionPolicy

        itemsize = getattr(PrecisionPolicy, args.precision)().compute_dtype.itemsize
        plan = ParallelPlan(
            pp=args.pipe, microbatches=args.microbatches or 2 * args.pipe,
            schedule=args.schedule, remat=args.remat, stash=args.stash,
            stash_cot=args.stash_cot,
        ).validate(cfg, global_batch=args.batch, seq_len=args.seq,
                   act_budget=int(args.act_budget_mb * 2**20) or None, itemsize=itemsize)
        if args.batch % plan.microbatches:
            ap.error(f"--batch {args.batch} must divide into {plan.microbatches} microbatches")
        if args.fused_backward:
            ap.error("the pipeline's head is the dense one; drop --fused-backward")
    tc = TrainConfig(
        optimizer=args.optimizer, lr=args.lr, precision=args.precision,
        fused_backward=args.fused_backward, log_every=1,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.steps if args.ckpt_dir else 0,
        **(plan_fields(plan) if plan else {"remat": args.remat}),
    )
    opt = get_opt(tc.optimizer, tc.lr)
    on_card = args.device == "cuda"
    state = make_state(cfg, opt, tc, seed=args.seed, device=args.device)
    step_fn = backend = None
    if plan is not None:
        step_fn, backend = build_train_pipeline_host(cfg, plan, tc,
                                                     lookahead=args.stash_lookahead)
    where = torch.cuda.get_device_name(0) if on_card else "cpu"
    n_params = sum(p.numel() for p in state["params"].parameters())
    print(f"{cfg.name} [{cfg.family}] on {where}: {n_params / 1e6:.1f}M params, "
          f"batch {args.batch} x seq {args.seq}, {args.precision}, "
          f"remat={args.remat}, fused_backward={args.fused_backward}"
          + (f", pipeline {plan.describe()}" if plan else ""))
    opt_bytes, adamw_bytes = optimizer_state_bytes(state)
    print(f"optimizer state {tc.optimizer}: {opt_bytes:,} B "
          f"(AdamW's f32 m and v: {adamw_bytes:,} B, ratio {opt_bytes / adamw_bytes:.3f})")
    data = DataPipeline(cfg, args.batch, args.seq, seed=args.seed)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_kernel_launches()
    tokens = args.batch * args.seq
    t0 = time.perf_counter()
    try:
        state, history = fit(
            cfg, tc, data, args.steps, opt, state=state, step_fn=step_fn,
            log=lambda line: None,
        )
    finally:
        data.close()
    wall = time.perf_counter() - t0
    for h in history:
        print(f"step {h['step']:4d} loss={h['loss']:.4f} gnorm={h['grad_norm']:.3f} "
              f"step_ms={h['step_s'] * 1e3:.1f} tokens/s={tokens / h['step_s']:.0f}")
    peak = f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB" if on_card else "n/a (cpu)"
    print(f"{args.steps} steps in {wall:.2f}s, peak device memory {peak}, "
          f"kernel launches {kernel_launches()}")
    if plan is not None:
        print_stash_report(plan, cfg, args.batch, args.seq, itemsize, backend)
    print("train main OK")


if __name__ == "__main__":
    main()
