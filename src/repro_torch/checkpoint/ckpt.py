"""npz checkpoints of the training state in the JAX package's format.

Counterpart of ``repro.checkpoint.ckpt`` (``save``, ``latest_step``,
``restore``). Layout: ``<dir>/step_<N>/shard_0.npz`` + ``manifest.json``,
leaves addressed by the same ``"/"``-joined keys (``params/embed/table``,
``opt/m/stack/g0/p0/mixer/wq``, ``scale/scale``, ``step``, ...), per-layer
tensors stacked ``(L, ...)`` as the JAX stack stores them
(``convert.state_leaves``). So a checkpoint the port writes restores in
``repro.checkpoint.ckpt.restore``, and the other way round.
``restore_resharded`` waits for ROADMAP queue 1 item 7.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.checkpoint.convert import leaves_to_flat, state_leaves


def save(directory: str, step: int, state: Mapping[str, Any], shard_index: int = 0) -> str:
    d = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(d, exist_ok=True)
    flat = leaves_to_flat(state_leaves(state))
    np.savez(os.path.join(d, f"shard_{shard_index}.npz"), **flat)
    manifest = {
        "step": step,
        "n_leaves": len(flat),
        "keys": sorted(flat.keys()),
        "shards": [f"shard_{shard_index}.npz"],
    }
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return d


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(m.group(1))
        for name in os.listdir(directory)
        if (m := re.match(r"step_(\d+)$", name))
    ]
    return max(steps) if steps else None


def _load_step(directory: str, step: Optional[int]) -> Dict[str, np.ndarray]:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    data: Dict[str, np.ndarray] = {}
    for shard in manifest["shards"]:
        with np.load(os.path.join(d, shard)) as z:
            for k in z.files:
                data[k] = z[k]
    return data


@torch.no_grad()
def restore(
    directory: str,
    state: Mapping[str, Any],
    step: Optional[int] = None,
    subset: str = "",
) -> Mapping[str, Any]:
    """Restore into ``state`` in place (shapes checked, values cast to each
    tensor's dtype) and return it. ``subset``: only keys with this prefix
    are loaded; the others keep their values (partial restore)."""
    data = _load_step(directory, step)
    for key, t, i in state_leaves(state):
        if not key.startswith(subset) or key not in data:
            continue
        arr = data[key] if i is None else data[key][i]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{key}: checkpoint {arr.shape} != state {tuple(t.shape)}")
        t.copy_(torch.as_tensor(np.array(arr)).to(t.dtype))
    return state


def restore_resharded(*args, **kwargs):
    raise NotImplementedError(
        "restore_resharded (reshard on load into another layout) is ROADMAP "
        "queue 1 item 7, 'the pipeline'"
    )
