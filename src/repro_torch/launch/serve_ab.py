"""Serving before and after a change, on one card: ``profile_serve`` and
``chip_smoke.py``'s serve phase of two checkouts, in turns a, b, b, a.

    PYTHONPATH=src python -m repro_torch.launch.serve_ab --a PARENT_DIR --b . \
        [--serve-only] [--rounds N]

Each turn runs, from that checkout's root and with its own ``src``,
``python -m repro_torch.launch.profile_serve`` and then ``chip_smoke.py``'s
build and serve phases, and prints one JSON line: tokens/s and mean TTFT of
both runs, ``decode_step_ms`` and ``prefill_chunk_ms``, and K5's device time
per decode step and K6's per prefill chunk (the profiler's family time over
the op calls that ``ServeEngine`` counted, divided by the layers). A turn
with the profiler takes ~11 minutes on an H100 (the profiled run and its
``key_averages``); ``--serve-only`` runs the serve phase alone (~2 minutes),
``--rounds`` repeats the a, b, b, a order.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

SERVE = ("import sys; sys.path.insert(0, 'src'); import chip_smoke as cs; "
         "cs.phase_build(); cs.phase_serve()")


def _json_lines(text: str):
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("{"):
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                continue


def _run(cmd, cwd: Path, timeout: int) -> str:
    env = dict(os.environ, PYTHONPATH=str(cwd / "src"))
    res = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=timeout)
    if res.returncode:
        raise RuntimeError(f"{cmd} in {cwd} failed ({res.returncode}):\n"
                           f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    return res.stdout


def serve_turn(tree: Path, label: str, timeout: int) -> dict:
    serve = [d for d in _json_lines(_run([sys.executable, "-c", SERVE], tree, timeout))
             if d.get("phase") == "serve"][-1]
    return dict(tree=label, serve_tokens_per_s=serve["tokens_per_s"],
                serve_mean_ttft_s=serve["run_mean_ttft_s"], serve_wall_s=serve["wall_s"])


def turn(tree: Path, label: str, n_layers: int, timeout: int) -> dict:
    prof = [d for d in _json_lines(_run(
        [sys.executable, "-m", "repro_torch.launch.profile_serve",
         "--out", str(tree / "profile_serve_out")], tree, timeout)) if "families" in d][-1]
    serve = serve_turn(tree, label, timeout)
    fam, calls = prof["families"], prof["kernel_launches"]
    k5 = fam.get("K5 paged_decode_kernel", {}).get("ms", 0.0)
    k6 = fam.get("K6 paged_prefill_kernel", {}).get("ms", 0.0)
    steps = calls["paged_decode_attention"] / n_layers
    chunks = calls["paged_prefill_attention"] / n_layers
    return dict(
        tree=label, card=prof["card"],
        profile_tokens_per_s=prof["tokens_per_s"],
        profile_mean_ttft_s=prof["run_mean_ttft_s"],
        serve_tokens_per_s=serve["serve_tokens_per_s"],
        serve_mean_ttft_s=serve["serve_mean_ttft_s"],
        decode_step_ms=prof["decode_step_ms"], prefill_chunk_ms=prof["prefill_chunk_ms"],
        k5_device_ms_per_decode_step=k5 / max(steps, 1),
        k6_device_ms_per_prefill_chunk=k6 / max(chunks, 1),
        decode_steps=steps, prefill_chunks=chunks,
        k5_kernels_per_step=fam.get("K5 paged_decode_kernel", {}).get("calls", 0)
        / max(steps, 1),
        device_busy_s=prof["device_busy_s"], idle_share=prof["idle_share"],
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--a", required=True, help="checkout before the change")
    ap.add_argument("--b", required=True, help="checkout with the change")
    ap.add_argument("--timeout", type=int, default=900, help="seconds a run may take")
    ap.add_argument("--serve-only", action="store_true", help="no profiler run")
    ap.add_argument("--rounds", type=int, default=1, help="times to run a, b, b, a")
    args = ap.parse_args(argv)
    from repro_torch.configs import get_config

    n_layers = get_config("granite-8b").n_layers
    trees = {"a": Path(args.a).resolve(), "b": Path(args.b).resolve()}
    for label in ("a", "b", "b", "a") * args.rounds:
        row = (serve_turn(trees[label], label, args.timeout) if args.serve_only
               else turn(trees[label], label, n_layers, args.timeout))
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
