"""Serving launcher of the PyTorch port: the paged continuous-batching
engine, or batched dense generation.

    # full granite-8b on the card, random weights from --seed, whole-prompt
    # admission (K1, K3, then K5); add --prefill-chunk 128 for chunked (K6)
    PYTHONPATH=src python -m repro_torch.launch.serve --full --arch granite-8b \
        --paged

    # reduced config on the CPU (plain versions of the kernels), int8 pool
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
        --paged --prefill-chunk 8 --device cpu --kv-dtype int8

    # full qwen3-moe-30b-a3b (128 experts, top-8) on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --full \
        --arch qwen3-moe-30b-a3b --paged --temperature 0

    # speculative decoding: 3 drafts a slot a tick, verified in one K6 pass
    # (greedy), by prompt lookup or by a paired 1-layer drafter model
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
        --paged --spec 3 --drafter model --device cpu

    # dense generation: --batch prompts of --prompt-len tokens over ring caches
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
        --device cpu --batch 4

    # full phi-3-vision-4.2b on the card: each request a random 576-patch
    # image prefix ahead of its text, admitted whole (K1, K3, then K5)
    PYTHONPATH=src python -m repro_torch.launch.serve --full \
        --arch phi-3-vision-4.2b --paged --prompt-len 512 --new-tokens 64

    # full falcon-mamba-7b on the card (the SSM, served dense: K3 and the
    # selective scan); with --paged its requests go through the engine's
    # dense fallback
    PYTHONPATH=src python -m repro_torch.launch.serve --full \
        --arch falcon-mamba-7b --prompt-len 512 --new-tokens 64

    # full recurrentgemma-2b on the card (the RG-LRU hybrid, served dense:
    # K1 on its 8 local-attention layers' prefill, K3, the RG-LRU scan)
    PYTHONPATH=src python -m repro_torch.launch.serve --full \
        --arch recurrentgemma-2b --prompt-len 512 --new-tokens 64

    # full seamless-m4t-medium on the card (the encoder-decoder, served
    # dense: each request behind random (1024, 1024) audio frames; K1 in the
    # encoder, the decoder's prefill and the cross-attention)
    PYTHONPATH=src python -m repro_torch.launch.serve --full \
        --arch seamless-m4t-medium --prompt-len 512 --new-tokens 64

Counterpart of ``repro.launch.serve``. With ``--paged``, requests of random
length (uniform in ``[prompt_len // 2, prompt_len]``, after an optional
shared system prompt) are admitted into ``--slots`` decode slots over the
paged KV pool and decoded together; a request is prefilled whole (padded to
a multiple of ``--page-size``), or in chunks of ``--prefill-chunk`` tokens,
or through the prefix cache (``--prefix-cache``); a vision config's
requests each carry a random (frontend_tokens, d_model) f32 image prefix,
the pool is sized for it, and they are always admitted whole; for a MoE
config the engine warns that expert capacity counts the pad rows, as JAX's
launcher leaves it; a family with non-KV decode state (the SSM, the RG-LRU
hybrid) and the encoder-decoder (each request with random frames of that
shape) go through the engine's dense fallback, as in JAX. Without it, ``--batch`` random
prompts of ``--prompt-len`` tokens (and images) generate together through
``train.serve.generate``. It runs on CUDA unless ``--device cpu`` is given,
and in bf16 at full size (``--full``), f32 when reduced. ``--kv-dtype
int8|fp8`` stores the pool as codes and scales (``bf16``, the default, at
the compute dtype); the launcher prints the pool's dtype, bytes per request
and capacity against bf16, as the JAX launcher does. ``--spec K`` drafts K
tokens a slot a tick (``--drafter ngram``, prompt lookup, or ``model``, the
paired config of ``serve.spec.paired_drafter_cfg`` with weights from
``--seed`` + 1) and verifies them in one batched pass; it forces temperature
0 and prints the accept rate and the tokens accepted a verify. Modes of the JAX
launcher that belong to later slices of the port exit with an error naming
the slice.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

LATER = {
    "mesh": "--mesh (memory techniques and multi-device) is ROADMAP queue 1 item 6",
    "trace": "--trace (the async front-end and its traces) is ROADMAP queue 1 item 5",
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the hand kernels) or cpu")
    ap.add_argument("--batch", type=int, default=4,
                    help="dense generation (without --paged): prompts a batch")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paged", action="store_true",
                    help="continuous batching over the paged KV pool")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--shared-prefix", type=int, default=0)
    ap.add_argument("--max-queue", type=int, default=0)
    ap.add_argument("--kv-dtype", default="bf16", choices=("bf16", "int8", "fp8"),
                    help="KV pool storage: the compute dtype, or int8 / fp8 codes")
    ap.add_argument("--spec", type=int, default=0, metavar="K",
                    help="speculative decoding: draft K tokens a tick and commit the "
                         "verified run (greedy: forces temperature 0; needs --paged)")
    ap.add_argument("--drafter", default="ngram", choices=("ngram", "model"),
                    help="--spec drafter: prompt lookup, or the paired reduced "
                         "same-family model (serve.spec.paired_drafter_cfg)")
    ap.add_argument("--mesh", default="")
    ap.add_argument("--trace", default="")
    args = ap.parse_args(argv)

    for flag in ("mesh", "trace"):
        if getattr(args, flag):
            ap.error(f"{LATER[flag]}, a later slice of the port")
    if args.spec and not args.paged:
        ap.error("--spec needs --paged (the verify pass is the paged-prefill path)")
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("CUDA is not available; pass --device cpu to run on the CPU")

    from repro_torch.configs import ASSIGNED, get_config, get_reduced
    from repro_torch.models import Runtime, init_params
    from repro_torch.serve import (EngineConfig, ServeEngine, paged_supported,
                                   paired_drafter_cfg)

    if args.arch not in ASSIGNED:
        ap.error(f"--arch must be one of {ASSIGNED}")
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    dtype = torch.float32 if args.reduced else torch.bfloat16
    params = init_params(cfg, seed=args.seed, device=args.device, dtype=dtype)
    rng = np.random.RandomState(args.seed)
    where = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    if not args.paged:
        _generate_dense(args, cfg, params, Runtime(dtype=dtype), rng, where)
        return
    paged = paged_supported(cfg)
    if not paged:
        print(f"{cfg.name}: family {cfg.family!r} -> dense fallback")
        if args.spec:
            ap.error(f"--spec needs a paged-capable family, not {args.arch}")
    max_prompt = args.prompt_len + args.shared_prefix
    ecfg = EngineConfig.capacity(
        max_prompt + cfg.frontend_tokens, args.new_tokens, slots=args.slots, page_size=args.page_size,
        headroom=2.0, cfg=cfg, kv_dtype=args.kv_dtype,
    ).engine(
        temperature=0.0 if args.spec else args.temperature, seed=args.seed,
        prefill_bucket=args.page_size, prefix_cache=args.prefix_cache,
        prefill_chunk=args.prefill_chunk, max_queue=args.max_queue,
        spec_tokens=args.spec, spec_drafter=args.drafter,
    )
    draft_params = draft_cfg = None
    if args.spec and args.drafter == "model":
        draft_cfg = paired_drafter_cfg(cfg)
        draft_params = init_params(draft_cfg, seed=args.seed + 1, device=args.device,
                                   dtype=dtype)
    eng = ServeEngine(cfg, params, Runtime(dtype=dtype), ecfg, device=args.device,
                      draft_params=draft_params, draft_cfg=draft_cfg)
    sys_prompt = rng.randint(0, cfg.vocab_size, (args.shared_prefix,)).astype(np.int32)
    rids = []
    for _ in range(args.requests):
        plen = rng.randint(max(args.prompt_len // 2, 1), args.prompt_len + 1)
        tokens = np.concatenate([
            sys_prompt, rng.randint(0, cfg.vocab_size, (plen,)).astype(np.int32)
        ])
        fe = (rng.randn(cfg.frontend_tokens, cfg.d_model).astype(np.float32)
              if cfg.frontend is not None else None)
        rids.append(eng.submit(tokens, args.new_tokens, frontend_embeds=fe))
    out = eng.run()
    s = eng.stats
    admission = ("dense fallback" if not paged else "prefix cache" if args.prefix_cache else
                 f"chunks of {args.prefill_chunk}" if args.prefill_chunk else "whole prompt")
    print(
        f"{cfg.name} [{cfg.family}] on {where}, admission by {admission}: "
        f"{sum(len(v) for v in out.values())} tokens, "
        f"{s['tokens_per_s']:.1f} tok/s, mean TTFT "
        f"{s['run_mean_ttft_s'] * 1e3:.0f}ms, evictions={s.get('evictions', 0)}, "
        f"prefill_chunks={s.get('prefill_chunks', 0)}, "
        f"kernel_launches={s['kernel_launches']}"
    )
    from repro_torch.kernels.paged_attention.quant import kv_token_bytes

    per_req = list(s.get("kv_bytes", {}).values())
    if paged:
        tok_bytes = kv_token_bytes(cfg.n_kv_heads, cfg.head_dim, args.kv_dtype)
        cap_factor = kv_token_bytes(cfg.n_kv_heads, cfg.head_dim, "bf16") / tok_bytes
        print(
            f"  kv-pool: dtype={args.kv_dtype}, bytes/token={tok_bytes * cfg.n_layers}, "
            f"bytes/request={np.mean(per_req):.0f} (mean over {len(per_req)}), "
            f"capacity_factor_vs_bf16={cap_factor:.2f}x, "
            f"pool_bytes={s['kv_pool_bytes_per_device']}"
        )
    else:
        print(f"  dense state: bytes/request={np.mean(per_req):.0f} "
              f"(mean over {len(per_req)})")
    if args.spec:
        print(
            f"  spec: k={args.spec} drafter={args.drafter} "
            f"accept_rate={s['spec_accept_rate']:.2f} "
            f"accepted_per_verify={s['spec_accepted_per_verify']:.2f} "
            f"verify_calls={s.get('spec_verify_calls', 0)}"
        )
    if args.prefix_cache:
        print(
            f"  prefix-cache: hits {s['prefix_hits']}/{s['prefix_lookups']}, "
            f"cached tokens {s['prefix_cached_tokens']}/{s.get('prompt_tokens', 0)}"
        )
    for rid in rids[:2]:
        print(f"  req[{rid}]: {out[rid][:12].tolist()}...")


def _generate_dense(args, cfg, params, rt, rng, where) -> None:
    """``--batch`` prompts of ``--prompt-len`` tokens through the dense path."""
    import time

    from repro_torch.train.serve import generate

    batch = {"tokens": rng.randint(0, cfg.vocab_size, (args.batch, args.prompt_len))}
    if cfg.frontend is not None:
        batch["frontend_embeds"] = rng.randn(
            args.batch, cfg.frontend_tokens, cfg.d_model).astype(np.float32)
    t0 = time.perf_counter()
    tokens, _ = generate(cfg, params, batch, rt, max_new_tokens=args.new_tokens,
                         temperature=args.temperature, seed=args.seed)
    if tokens.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"{cfg.name} [{cfg.family}] on {where}, dense: {tokens.numel()} tokens in "
          f"{dt:.1f}s")
    for b in range(min(2, args.batch)):
        print(f"  seq[{b}]: {tokens[b].tolist()}")


if __name__ == "__main__":
    main()
