"""Carry parameters and training state between the JAX package's trees and
the port's :class:`LM` and state dict.

``params_from_jax`` takes the JAX parameter tree as numpy arrays, either
nested (``np.asarray`` over ``repro.models.init_params``) or as the flat
``"/"``-joined keys that ``repro.checkpoint.ckpt`` writes into its npz
(``stack/g0/p0/mixer/wq``, ...). The stack's homogeneous storage keeps every
leaf stacked ``(L, ...)`` under ``stack/g0/p0``; layer ``i`` takes index
``i``. A patterned stack (recurrentgemma's rglru, rglru, local unit) keeps
JAX's ``param_groups``: ``stack/g{g}/p{j}`` holds unit position j of group
g, stacked over the group's repeats, and layer ``off_g + r * u + j`` takes
index r (``stack.param_layout``; the LM's ``Stack.layout`` carries it, so
the keys are written back the same way). A MoE layer's ``ffn`` holds
``router`` (L, d, E), ``w_up`` / ``w_gate`` (L, E, d, f) and ``w_down`` (L,
E, f, d), beside it an optional
``extra_mlp`` (the shared or dense-residual MLP). A Mamba layer's
``mixer`` holds ``in_proj``, ``conv_w``, ``conv_b``, ``x_proj``,
``dt_proj``, ``dt_bias``, ``A_log``, ``D`` and ``out_proj``, and its block
no ``norm2`` or ``ffn``. An RG-LRU layer's ``mixer`` holds ``w_in``,
``w_gate``, ``conv_w``, ``conv_b``, ``gate_a``, ``bias_a``, ``gate_x``,
``bias_x``, ``lam`` and ``w_out``, beside the block's ``norm2`` and dense
``ffn``. An encoder-decoder's tree adds ``enc_stack`` (the encoder's
homogeneous storage, ``enc_stack/g0/p0/...``, layer i at index i) and
``enc_norm``, and each decoder block's ``norm_x`` and ``cross/{wq, wk,
wv, wo}``; a LayerNorm config's norms carry ``bias`` beside ``scale``.
``params_to_numpy`` is the inverse, back to the nested JAX layout.

The training state (``repro_torch.train.loop.make_state``) carries across
whole with ``state_from_jax`` / ``state_to_numpy``: every optimizer entry
that is a list aligned with ``LM.parameters()`` (AdamW's ``m`` and ``v``,
SGD's ``mu``, 1-bit Adam's ``m``, ``v`` and ``ef``) is a tree shaped like the
params in the JAX layout, and every scalar (``opt/step``, ``scale/scale``,
``scale/good_steps``, ``step``) a scalar. The low-bit optimizers' ``slots``,
one per JAX leaf (``leaf_groups``), become ``opt/slots/<leaf key>/...``:
``m/codes`` and ``m/scales`` (uint8 stays uint8) for a quantized leaf, f32
``m`` and ``v`` in the leaf's stacked shape for a small one, ``gs`` for the
4-bit optimizer. The optimizer's ``groups`` is not a tensor and is not
saved: it is the LM's ``leaf_groups``. ``state_leaves`` lists the flat keys
and the tensors behind them, for ``checkpoint.ckpt``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import Attention
from repro_torch.models.layers import MLP, Embed, Head, Norm
from repro_torch.models.lm import LM, _encoder_cfg
from repro_torch.models.moe import MoE
from repro_torch.models.rglru import RGLRU
from repro_torch.models.ssm import Mamba
from repro_torch.models.stack import (Block, Slot, Stack, check_served, param_groups,
                                      param_layout)

# (flat key, tensor, index into the stacked leaf (its layer's repeat) or None)
Leaf = Tuple[str, torch.Tensor, Optional[int]]
# a recurrent mixer's leaves in its module's argument order; the f32 ones
MAMBA_KEYS = ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias", "A_log",
              "D", "out_proj")
MAMBA_F32 = ("conv_b", "dt_bias", "A_log", "D")
RGLRU_KEYS = ("w_in", "w_gate", "conv_w", "conv_b", "gate_a", "bias_a", "gate_x", "bias_x",
              "lam", "w_out")
RGLRU_F32 = ("conv_b", "bias_a", "bias_x", "lam")


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


def jax_key(name: str, layouts: Mapping[str, Tuple[Slot, ...]]) -> Tuple[str, Optional[int]]:
    """A parameter name of :class:`LM` -> (its JAX tree key, index into the
    stacked leaf), by each stack's ``layout`` (``layouts["stack"]``, and an
    encoder-decoder's ``layouts["enc_stack"]``): ``stack.layers.3.mixer.wq``
    -> (``stack/g0/p0/mixer/wq``, 3) in a homogeneous stack, and in
    recurrentgemma's patterned storage ``stack.layers.25.mixer.lam`` ->
    (``stack/g1/p1/mixer/lam``, 0)."""
    parts = name.split(".")
    if parts[0] in layouts:
        slot = layouts[parts[0]][int(parts[2])]
        return "/".join([parts[0], f"g{slot.group}", f"p{slot.pos}", *parts[3:]]), slot.repeat
    return "/".join(parts), None


def layouts_of(params: LM) -> Dict[str, Tuple[Slot, ...]]:
    """Each stack's ``layout`` by its attribute name, for :func:`jax_key`."""
    out = {"stack": params.stack.layout}
    if params.enc_stack is not None:
        out["enc_stack"] = params.enc_stack.layout
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.is_floating_point() else t).numpy()


def leaves_to_flat(leaves: List[Leaf]) -> Dict[str, np.ndarray]:
    """Flat JAX-layout numpy arrays; per-layer leaves are stacked over their
    index ((L, ...), or a group's repeats)."""
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
    layouts = layouts_of(params)
    for (name, _), t in zip(named, tensors):
        key, i = jax_key(name, layouts)
        out.append((f"{prefix}{key}", t, i))
    return out


class JaxLeaf(NamedTuple):
    """One leaf of the JAX parameter tree: its key, the indices into
    ``LM.parameters()`` of the tensors that form it (in stacking order), and
    its shape — ``(L, ...)`` (or ``(R, ...)``, a group's repeats) for a
    stacked per-layer leaf."""
    key: str
    members: Tuple[int, ...]
    shape: Tuple[int, ...]


def leaf_groups(params: LM) -> List[JaxLeaf]:
    """The JAX leaves over ``params.parameters()``, in order of first
    appearance: what the optimizers take as ``groups``."""
    members: Dict[str, List[Tuple[int, int]]] = {}
    shapes: Dict[str, Tuple[int, ...]] = {}
    for idx, (key, t, i) in enumerate(param_leaves(params)):
        members.setdefault(key, []).append((-1 if i is None else i, idx))
        shapes[key] = tuple(t.shape)
    out = []
    for key, rows in members.items():
        rows.sort()
        stacked = rows[0][0] >= 0
        shape = (len(rows), *shapes[key]) if stacked else shapes[key]
        out.append(JaxLeaf(key, tuple(idx for _, idx in rows), shape))
    return out


def params_from_jax(
    tree: Mapping[str, Any], cfg: ArchConfig, *, device, dtype=torch.float32
) -> LM:
    """The port's parameters from a JAX tree of numpy arrays. Matmul weights,
    and the recurrent mixers' ``conv_w`` and the RG-LRU's gate blocks, are
    stored once at ``dtype`` (JAX casts them at every use); norm scales and
    biases, the head, a tied embedding table and the recurrent mixers'
    vectors stay f32."""
    if any("/" in k for k in tree):
        tree = unflatten(tree)
    check_served(cfg)

    def t(a, dt):
        return torch.tensor(np.asarray(a, np.float32), device=device).to(dt)

    def norm(p, i=None):
        pick = (lambda a: a) if i is None else (lambda a: a[i])
        bias = t(pick(p["bias"]), torch.float32) if "bias" in p else None
        return Norm(t(pick(p["scale"]), torch.float32), bias)

    def mlp(f, i):
        return MLP(t(f["w_up"][i], dtype), t(f["w_down"][i], dtype),
                   t(f["w_gate"][i], dtype) if "w_gate" in f else None)

    def recurrent(cls, m, i, keys, f32):
        return cls(*(t(m[k][i], torch.float32 if k in f32 else dtype) for k in keys))

    def attention(m, i):
        return Attention(*(t(m[k][i], dtype) for k in ("wq", "wk", "wv", "wo")))

    def stack(groups, scfg):
        want = {f"g{gi}": sorted(f"p{j}" for j in range(len(pattern)))
                for gi, (pattern, _) in enumerate(param_groups(scfg))}
        got = {g: sorted(v) for g, v in groups.items()}
        if got != want:
            raise ValueError(f"{scfg.name}: stack groups {got} are not param_groups' {want}")
        layout = param_layout(scfg)
        blocks = []
        for slot in layout:
            layers, i = groups[f"g{slot.group}"][f"p{slot.pos}"], slot.repeat
            m = layers["mixer"]
            xattn = {}
            if "cross" in layers:            # an encoder-decoder's decoder block
                xattn = dict(norm_x=norm(layers["norm_x"], i),
                             cross=attention(layers["cross"], i))
            if "in_proj" in m:               # Mamba-1, mixer-only
                blocks.append(Block(norm(layers["norm1"], i),
                                    recurrent(Mamba, m, i, MAMBA_KEYS, MAMBA_F32), **xattn))
                continue
            mixer = recurrent(RGLRU, m, i, RGLRU_KEYS, RGLRU_F32) if "lam" in m else (
                attention(m, i))
            f = layers["ffn"]
            if "router" in f:
                ffn = MoE(t(f["router"][i], dtype), t(f["w_up"][i], dtype),
                          t(f["w_down"][i], dtype),
                          t(f["w_gate"][i], dtype) if "w_gate" in f else None)
            else:
                ffn = mlp(f, i)
            blocks.append(Block(
                norm(layers["norm1"], i), mixer, norm(layers["norm2"], i), ffn,
                mlp(layers["extra_mlp"], i) if "extra_mlp" in layers else None, **xattn,
            ))
        return Stack(blocks, layout)

    enc = {}
    if cfg.is_encdec:
        enc = dict(enc_stack=stack(tree["enc_stack"], _encoder_cfg(cfg)),
                   enc_norm=norm(tree["enc_norm"]))
    embed_dtype = torch.float32 if cfg.tie_embeddings else dtype
    head = None if cfg.tie_embeddings else Head(t(tree["head"]["w"], torch.float32))
    return LM(
        Embed(t(tree["embed"]["table"], embed_dtype)),
        stack(tree["stack"], cfg),
        norm(tree["final_norm"]),
        head,
        **enc,
    )


def params_to_numpy(params: LM) -> Dict[str, Any]:
    """The nested JAX layout (stacked leaves, patterned groups as the
    stack's ``layout`` says) as f32 numpy."""
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


def _slot_leaves(slot: Mapping[str, Any], prefix: str, shape) -> List[Leaf]:
    out = []
    for k, v in slot.items():
        if isinstance(v, Mapping):                          # {"codes", "scales"}
            out += _slot_leaves(v, f"{prefix}{k}/", shape)
        elif k in ("m", "v"):                               # a small leaf's f32 moment
            out.append((f"{prefix}{k}", v.view(shape), None))
        else:
            out.append((f"{prefix}{k}", v, None))
    return out


def _subtree(tree: Mapping[str, Any], key: str) -> Mapping[str, Any]:
    for part in key.split("/"):
        tree = tree[part]
    return tree


def state_leaves(state: Mapping[str, Any]) -> List[Leaf]:
    """Every tensor of a port training state under its JAX state key."""
    params = state["params"]
    out = param_leaves(params, prefix="params/")
    for k, v in state["opt"].items():
        if k == "groups":
            continue
        if k == "slots":
            leaves = leaf_groups(params)
            if tuple(state["opt"]["groups"]) != tuple(lf.members for lf in leaves):
                raise ValueError("optimizer slots are not grouped by the LM's JAX "
                                 "leaves: initialise it with leaf_groups(params)")
            for lf, slot in zip(leaves, v):
                out += _slot_leaves(slot, f"opt/slots/{lf.key}/", lf.shape)
        elif isinstance(v, (list, tuple)):
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

    def slot(node):
        return {k: slot(v) if isinstance(v, Mapping)
                else scalar(v).reshape(-1) if k in ("m", "v") else scalar(v)
                for k, v in node.items()}

    leaves = leaf_groups(params)
    opt: Dict[str, Any] = {}
    for k, v in tree["opt"].items():
        if k == "slots":
            opt[k] = [slot(_subtree(v, lf.key)) for lf in leaves]
        elif isinstance(v, Mapping):
            opt[k] = tensors_from_tree(params, v, device=device)
        else:
            opt[k] = scalar(v)
    opt["groups"] = tuple(lf.members for lf in leaves)
    return {
        "params": params,
        "opt": opt,
        "scale": {k: scalar(v) for k, v in tree["scale"].items()},
        "step": scalar(tree["step"]),
    }
