"""Carry parameters and training state between the JAX package's trees and
the port's :class:`LM` and state dict.

``params_from_jax`` takes the JAX parameter tree as numpy arrays, either
nested (``np.asarray`` over ``repro.models.init_params``) or as the flat
``"/"``-joined keys that ``repro.checkpoint.ckpt`` writes into its npz
(``stack/g0/p0/mixer/wq``, ...). The stack's homogeneous storage keeps every
leaf stacked ``(L, ...)`` under ``stack/g0/p0``; layer ``i`` takes index
``i``. ``params_to_numpy`` is the inverse, back to the nested JAX layout.

The training state (``repro_torch.train.loop.make_state``) carries across
whole with ``state_from_jax`` / ``state_to_numpy``: every optimizer entry
that is a list aligned with ``LM.parameters()`` (AdamW's ``m`` and ``v``,
SGD's ``mu``) is a tree shaped like the params in the JAX layout, and every
scalar (``opt/step``, ``scale/scale``, ``scale/good_steps``, ``step``) a
scalar. ``state_leaves`` lists the flat keys and the tensors behind them,
for ``checkpoint.ckpt``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import Attention
from repro_torch.models.layers import MLP, Embed, Head, Norm
from repro_torch.models.lm import LM
from repro_torch.models.stack import Block, Stack, check_served

# (flat key, tensor, layer index into the stacked (L, ...) leaf or None)
Leaf = Tuple[str, torch.Tensor, Optional[int]]


def unflatten(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """``{"a/b/c": x}`` -> ``{"a": {"b": {"c": x}}}``."""
    tree: Dict[str, Any] = {}
    for key, leaf in flat.items():
        node = tree
        *path, last = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf
    return tree


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """The inverse of :func:`unflatten`."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def jax_key(name: str) -> Tuple[str, Optional[int]]:
    """A parameter name of :class:`LM` -> (its JAX tree key, layer index):
    ``stack.layers.3.mixer.wq`` -> (``stack/g0/p0/mixer/wq``, 3)."""
    parts = name.split(".")
    if parts[0] == "stack":
        return "/".join(["stack", "g0", "p0", *parts[3:]]), int(parts[2])
    return "/".join(parts), None


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.is_floating_point() else t).numpy()


def leaves_to_flat(leaves: List[Leaf]) -> Dict[str, np.ndarray]:
    """Flat JAX-layout numpy arrays; per-layer leaves are stacked (L, ...)."""
    flat: Dict[str, np.ndarray] = {}
    stacked: Dict[str, Dict[int, np.ndarray]] = {}
    for key, t, i in leaves:
        if i is None:
            flat[key] = _numpy(t)
        else:
            stacked.setdefault(key, {})[i] = _numpy(t)
    for key, rows in stacked.items():
        flat[key] = np.stack([rows[i] for i in range(len(rows))])
    return flat


def param_leaves(params: LM, tensors=None, prefix: str = "") -> List[Leaf]:
    """Leaves of ``tensors`` (default: the parameters themselves), aligned
    with ``params.named_parameters()``, under ``prefix``."""
    named = list(params.named_parameters())
    tensors = [p for _, p in named] if tensors is None else list(tensors)
    if len(tensors) != len(named):
        raise ValueError(f"{len(tensors)} tensors for {len(named)} parameters")
    out = []
    for (name, _), t in zip(named, tensors):
        key, i = jax_key(name)
        out.append((f"{prefix}{key}", t, i))
    return out


def params_from_jax(
    tree: Mapping[str, Any], cfg: ArchConfig, *, device, dtype=torch.float32
) -> LM:
    """The port's parameters from a JAX tree of numpy arrays. Matmul weights
    are stored once at ``dtype`` (JAX casts them at every use); norm scales,
    the head and a tied embedding table stay f32."""
    if any("/" in k for k in tree):
        tree = unflatten(tree)
    check_served(cfg)
    groups = tree["stack"]
    if set(groups) != {"g0"} or set(groups["g0"]) != {"p0"}:
        raise NotImplementedError(
            f"{cfg.name}: patterned parameter storage {sorted(groups)} belongs "
            "to ROADMAP queue 1, 'the other families'"
        )
    layers = groups["g0"]["p0"]

    def t(a, dt):
        return torch.tensor(np.asarray(a, np.float32), device=device).to(dt)

    def norm(p, i=None):
        pick = (lambda a: a) if i is None else (lambda a: a[i])
        bias = t(pick(p["bias"]), torch.float32) if "bias" in p else None
        return Norm(t(pick(p["scale"]), torch.float32), bias)

    blocks = []
    for i in range(cfg.n_layers):
        m, f = layers["mixer"], layers["ffn"]
        blocks.append(Block(
            norm(layers["norm1"], i),
            Attention(*(t(m[k][i], dtype) for k in ("wq", "wk", "wv", "wo"))),
            norm(layers["norm2"], i),
            MLP(t(f["w_up"][i], dtype), t(f["w_down"][i], dtype),
                t(f["w_gate"][i], dtype) if "w_gate" in f else None),
        ))
    embed_dtype = torch.float32 if cfg.tie_embeddings else dtype
    head = None if cfg.tie_embeddings else Head(t(tree["head"]["w"], torch.float32))
    return LM(
        Embed(t(tree["embed"]["table"], embed_dtype)),
        Stack(blocks),
        norm(tree["final_norm"]),
        head,
    )


def params_to_numpy(params: LM) -> Dict[str, Any]:
    """The nested JAX layout (stacked ``(L, ...)`` leaves) as f32 numpy."""
    return unflatten(leaves_to_flat(param_leaves(params)))


def tensors_from_tree(
    params: LM, tree: Mapping[str, Any], *, device
) -> List[torch.Tensor]:
    """f32 tensors aligned with ``params.parameters()`` from a params-shaped
    JAX tree (nested or flat) — an optimizer's ``m``, ``v`` or ``mu``."""
    flat = tree if any("/" in k for k in tree) else flatten(tree)
    out = []
    for key, _, i in param_leaves(params):
        a = np.asarray(flat[key], np.float32)
        out.append(torch.tensor(a if i is None else a[i], device=device))
    return out


def state_leaves(state: Mapping[str, Any]) -> List[Leaf]:
    """Every tensor of a port training state under its JAX state key."""
    params = state["params"]
    out = param_leaves(params, prefix="params/")
    for k, v in state["opt"].items():
        if isinstance(v, (list, tuple)):
            out += param_leaves(params, v, prefix=f"opt/{k}/")
        else:
            out.append((f"opt/{k}", v, None))
    for k, v in state["scale"].items():
        out.append((f"scale/{k}", v, None))
    out.append(("step", state["step"], None))
    return out


def state_to_numpy(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The JAX training-state tree (``repro.train.loop.make_state`` layout)
    as numpy: params, optimizer state, loss scale and step."""
    return unflatten(leaves_to_flat(state_leaves(state)))


def state_from_jax(
    tree: Mapping[str, Any], cfg: ArchConfig, *, device
) -> Dict[str, Any]:
    """A port training state from a JAX state tree of numpy arrays (nested,
    or the flat keys of a checkpoint). Params come back as f32 masters with
    ``requires_grad`` on."""
    if any("/" in k for k in tree):
        tree = unflatten(tree)
    params = params_from_jax(tree["params"], cfg, device=device).requires_grad_(True)

    def scalar(a):
        return torch.tensor(np.asarray(a), device=device)

    opt = {k: (tensors_from_tree(params, v, device=device) if isinstance(v, Mapping)
               else scalar(v)) for k, v in tree["opt"].items()}
    return {
        "params": params,
        "opt": opt,
        "scale": {k: scalar(v) for k, v in tree["scale"].items()},
        "step": scalar(tree["step"]),
    }
