"""Training loop, single device: model, precision, remat, optimizer.

Counterpart of ``repro.train.loop`` for ``mode="single"``. The state is a
dict as in the JAX package — ``params`` (an :class:`LM` of f32 masters with
``requires_grad``), ``opt`` (lists aligned with ``LM.parameters()`` plus the
step), ``scale`` (the dynamic loss scale) and ``step`` — and one step
updates it in place: gradients come from ``torch.autograd.grad`` (nothing
accumulates in ``.grad``), the optimizer runs only on finite grads (the JAX
step's ``where(finite, new, old)``), and the params change in place.

Other execution modes (``dp_compressed``, the distributed trainer),
gradient compression, ZeRO and the pipeline belong to later slices
(ROADMAP queue 1 items 6 and 7) and raise.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.precision import (
    PrecisionPolicy,
    init_scale_state,
    scale_loss,
    unscale_and_check,
)
from repro_torch.models import LM, Runtime, init_params, loss_fn
from repro_torch.optim import Optimizer, apply_updates, clip_by_global_norm

LATER = "ROADMAP queue 1 item 6, 'memory techniques and multi-device'"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"
    lr: Any = 3e-4
    grad_clip: float = 1.0
    precision: str = "f32"            # f32 | bf16 | fp16
    remat: str = "none"               # none | full | dots
    remat_period: int = 1             # layers per checkpoint (remat full/dots)
    fused_backward: bool = False      # chunked-CE head instead of dense logits
    compression: Any = None           # later slice: must stay None
    zero_stage: int = 0               # later slice: must stay 0
    pipe: int = 1                     # later slice: must stay 1
    microbatches: int = 1             # later slice: must stay 1
    log_every: int = 10
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0

    def __post_init__(self):
        if self.compression is not None:
            raise NotImplementedError(f"gradient compression is {LATER}")
        if self.zero_stage:
            raise NotImplementedError(f"ZeRO (zero_stage={self.zero_stage}) is {LATER}")
        if self.pipe > 1 or self.microbatches > 1:
            raise NotImplementedError(
                f"pipe={self.pipe}, microbatches={self.microbatches}: the pipeline "
                f"needs {LATER}, then queue 1 item 7"
            )
        if self.precision not in ("f32", "bf16", "fp16"):
            raise ValueError(f"precision {self.precision!r} not in f32|bf16|fp16")


def _policy(tc: TrainConfig) -> PrecisionPolicy:
    return getattr(PrecisionPolicy, tc.precision)()


def make_state(
    cfg: ArchConfig, opt: Optimizer, tc: TrainConfig, seed: int = 0, *,
    device="cuda", params: Optional[LM] = None,
) -> Dict[str, Any]:
    """Fresh state: ``params`` (default: ``init_params(cfg, seed=seed)`` in
    f32 on ``device``), the optimizer's initial state, the loss scale."""
    if params is None:
        params = init_params(cfg, seed=seed, device=device, dtype=torch.float32)
    params.requires_grad_(True)
    dev = next(params.parameters()).device
    return {
        "params": params,
        "opt": opt.init(list(params.parameters())),
        "scale": init_scale_state(_policy(tc), device=dev),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _runtime(tc: TrainConfig) -> Runtime:
    return Runtime(dtype=_policy(tc).compute_dtype, remat=tc.remat,
                   remat_period=tc.remat_period, fused_backward=tc.fused_backward)


def finish_step(
    state: Dict[str, Any],
    grads: List[torch.Tensor],
    metrics: Dict[str, torch.Tensor],
    tc: TrainConfig,
    policy: PrecisionPolicy,
    opt: Optimizer,
) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """Step tail: unscale and check the grads, clip, and update params and
    optimizer state in place unless a grad is non-finite."""
    grads, scale_state, finite = unscale_and_check(grads, state["scale"], policy)
    zero = torch.zeros((), dtype=torch.float32, device=finite.device)
    gnorm = zero
    if tc.grad_clip:
        grads, gnorm = clip_by_global_norm(grads, tc.grad_clip)
    opt_state = state["opt"]
    if bool(finite):               # skip the update on non-finite grads (fp16)
        params = list(state["params"].parameters())
        updates, opt_state = opt.update(grads, opt_state, params)
        apply_updates(params, updates)
    new_state = {
        "params": state["params"],
        "opt": opt_state,
        "scale": scale_state,
        "step": state["step"] + 1,
    }
    metrics = dict(metrics, grad_norm=gnorm, wire_bytes=zero,
                   loss_scale=scale_state["scale"])
    return new_state, metrics


def make_train_step(
    cfg: ArchConfig,
    opt: Optimizer,
    tc: TrainConfig,
    mode: str = "single",
    rt: Optional[Runtime] = None,
) -> Callable:
    if mode != "single":
        raise NotImplementedError(f"mode={mode!r}: only 'single' is ported; "
                                  f"the others are {LATER}")
    policy = _policy(tc)
    rt = rt if rt is not None else _runtime(tc)

    def step(state, batch):
        params = state["params"]
        loss, metrics = loss_fn(cfg, params, batch, rt)
        grads = torch.autograd.grad(scale_loss(loss, state["scale"]),
                                    list(params.parameters()))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return finish_step(state, list(grads), metrics, tc, policy, opt)

    return step


def fit(
    cfg: ArchConfig,
    tc: TrainConfig,
    data: Iterable[Dict[str, Any]],
    steps: int,
    opt: Optimizer,
    state: Optional[Dict[str, Any]] = None,
    step_fn: Optional[Callable] = None,
    log: Callable[[str], None] = print,
    *,
    device="cuda",
) -> Tuple[Dict[str, Any], list]:
    """Run ``steps`` steps over ``data`` (numpy batches, moved to the
    state's device). Logs JAX's line every ``tc.log_every`` steps and at
    step 1; each history entry also has ``step_s``, the mean wall time of
    the steps since the previous entry (the float conversion of the
    metrics waits for the device)."""
    if state is None:
        state = make_state(cfg, opt, tc, device=device)
    if step_fn is None:
        step_fn = make_train_step(cfg, opt, tc)
    dev = state["step"].device
    history = []
    it = iter(data)
    t0 = t_prev = time.time()
    i_prev = 0
    for i in range(steps):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in next(it).items()}
        state, metrics = step_fn(state, batch)
        if (i + 1) % tc.log_every == 0 or i == 0:
            m = {k: float(v) for k, v in metrics.items()}
            now = time.time()
            history.append({"step": i + 1, **m,
                            "step_s": (now - t_prev) / (i + 1 - i_prev)})
            t_prev, i_prev = now, i + 1
            log(
                f"step {i+1:5d} loss={m['loss']:.4f} xent={m['xent']:.4f} "
                f"gnorm={m['grad_norm']:.2f} ({(now-t0)/(i+1):.2f}s/it)"
            )
        if tc.ckpt_dir and tc.ckpt_every and (i + 1) % tc.ckpt_every == 0:
            from repro_torch.checkpoint import ckpt

            ckpt.save(tc.ckpt_dir, i + 1, state)
    return state, history
