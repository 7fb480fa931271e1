"""Carry parameters between the JAX package's tree and the port's :class:`LM`.

``params_from_jax`` takes the JAX parameter tree as numpy arrays, either
nested (``np.asarray`` over ``repro.models.init_params``) or as the flat
``"/"``-joined keys that ``repro.checkpoint.ckpt`` writes into its npz
(``stack/g0/p0/mixer/wq``, ...). The stack's homogeneous storage keeps every
leaf stacked ``(L, ...)`` under ``stack/g0/p0``; layer ``i`` takes index
``i``. ``params_to_numpy`` is the inverse, back to the nested JAX layout.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import Attention
from repro_torch.models.layers import MLP, Embed, Head, Norm
from repro_torch.models.lm import LM
from repro_torch.models.stack import Block, Stack, check_served


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


def params_from_jax(
    tree: Mapping[str, Any], cfg: ArchConfig, device="cpu", dtype=torch.float32
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
    def a(x):
        return x.detach().float().cpu().numpy()

    def stacked(get):
        return np.stack([a(get(b)) for b in params.stack.layers])

    def norm_tree(get):
        out = {"scale": stacked(lambda b: get(b).scale)}
        if get(params.stack.layers[0]).bias is not None:
            out["bias"] = stacked(lambda b: get(b).bias)
        return out

    ffn = {
        "w_up": stacked(lambda b: b.ffn.w_up),
        "w_down": stacked(lambda b: b.ffn.w_down),
    }
    if params.stack.layers[0].ffn.w_gate is not None:
        ffn["w_gate"] = stacked(lambda b: b.ffn.w_gate)
    layer = {
        "norm1": norm_tree(lambda b: b.norm1),
        "mixer": {k: stacked(lambda b, k=k: getattr(b.mixer, k))
                  for k in ("wq", "wk", "wv", "wo")},
        "norm2": norm_tree(lambda b: b.norm2),
        "ffn": ffn,
    }
    final = {"scale": a(params.final_norm.scale)}
    if params.final_norm.bias is not None:
        final["bias"] = a(params.final_norm.bias)
    tree = {
        "embed": {"table": a(params.embed.table)},
        "stack": {"g0": {"p0": layer}},
        "final_norm": final,
    }
    if params.head is not None:
        tree["head"] = {"w": a(params.head.w)}
    return tree
