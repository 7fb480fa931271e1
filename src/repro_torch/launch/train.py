"""Training launcher of the PyTorch port: the single-device training step.

    # gemma3-1b at full width and depth on the card, bf16 over f32 masters
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b --full \
        --precision bf16 --batch 4 --seq 2048 --steps 10 --fused-backward

    # reduced config on the CPU (plain versions of the kernels)
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \
        --reduced --device cpu --steps 3 --batch 2 --seq 128

Counterpart of the single-device path of ``repro.launch.train``: random
weights from ``--seed``, batches from ``data.DataPipeline(seed=--seed)``,
``train.loop.fit`` with AdamW (or ``--optimizer``). It prints each step's
loss, step time, tokens/s, the peak device memory and the launches of the
flash-attention (K1, K2) and RMSNorm (K3, K4) kernels. It runs on CUDA
unless ``--device cpu`` is given. The JAX launcher's mesh, ZeRO, pipeline
and stash flags belong to later slices of the port and are not here.
"""
from __future__ import annotations

import argparse
import time

import torch


def kernel_launches() -> dict:
    """The K1-K4 launch counters of this process."""
    from repro_torch.kernels.flash_attention import cuda as fa
    from repro_torch.kernels.rmsnorm import cuda as rn

    return {**fa.LAUNCHES, **rn.LAUNCHES}


def reset_kernel_launches() -> None:
    from repro_torch.kernels.flash_attention import cuda as fa
    from repro_torch.kernels.rmsnorm import cuda as rn

    fa.reset_launches()
    rn.reset_launches()


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
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the hand kernels) or cpu")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("CUDA is not available; pass --device cpu to run on the CPU")

    from repro_torch.configs import ASSIGNED, get_config, get_reduced
    from repro_torch.data import DataPipeline
    from repro_torch.optim import get as get_opt
    from repro_torch.train import TrainConfig, fit, make_state

    if args.arch not in ASSIGNED:
        ap.error(f"--arch must be one of {ASSIGNED}")
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    tc = TrainConfig(
        optimizer=args.optimizer, lr=args.lr, precision=args.precision,
        remat=args.remat, fused_backward=args.fused_backward, log_every=1,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.steps if args.ckpt_dir else 0,
    )
    opt = get_opt(tc.optimizer, tc.lr)
    on_card = args.device == "cuda"
    state = make_state(cfg, opt, tc, seed=args.seed, device=args.device)
    where = torch.cuda.get_device_name(0) if on_card else "cpu"
    n_params = sum(p.numel() for p in state["params"].parameters())
    print(f"{cfg.name} [{cfg.family}] on {where}: {n_params / 1e6:.1f}M params, "
          f"batch {args.batch} x seq {args.seq}, {args.precision}, "
          f"remat={args.remat}, fused_backward={args.fused_backward}")
    data = DataPipeline(cfg, args.batch, args.seq, seed=args.seed)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_kernel_launches()
    tokens = args.batch * args.seq
    t0 = time.perf_counter()
    try:
        state, history = fit(
            cfg, tc, data, args.steps, opt, state=state, log=lambda line: None,
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
    print("train main OK")


if __name__ == "__main__":
    main()
