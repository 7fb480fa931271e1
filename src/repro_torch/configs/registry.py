"""Registry of assigned architectures (+ the survey's own demo config)."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import ArchConfig, INPUT_SHAPES, ShapeSpec, reduced
from repro_torch.configs.granite_34b import CONFIG as GRANITE_34B
from repro_torch.configs.seamless_m4t_medium import CONFIG as SEAMLESS_M4T_MEDIUM
from repro_torch.configs.gemma3_1b import CONFIG as GEMMA3_1B
from repro_torch.configs.granite_8b import CONFIG as GRANITE_8B
from repro_torch.configs.falcon_mamba_7b import CONFIG as FALCON_MAMBA_7B
from repro_torch.configs.phi3_vision_4_2b import CONFIG as PHI3_VISION_4_2B
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as QWEN3_MOE_30B_A3B
from repro_torch.configs.recurrentgemma_2b import CONFIG as RECURRENTGEMMA_2B
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as MOONSHOT_V1_16B_A3B
from repro_torch.configs.arctic_480b import CONFIG as ARCTIC_480B

# The survey has no model of its own; this is the framework's default demo
# config (a ~100M llama-style LM used by examples/ and the trainer default).
SURVEY_DEMO = ArchConfig(
    name="survey-demo-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    head_dim=64,
    d_ff=2048,
    vocab_size=32000,
    mlp_gated=True,
    norm="rmsnorm",
    pattern=("attn",),
    ffn_kind="dense",
    source="survey demo model (this repo)",
)

ARCHITECTURES: Dict[str, ArchConfig] = {
    c.name: c
    for c in [
        GRANITE_34B,
        SEAMLESS_M4T_MEDIUM,
        GEMMA3_1B,
        GRANITE_8B,
        FALCON_MAMBA_7B,
        PHI3_VISION_4_2B,
        QWEN3_MOE_30B_A3B,
        RECURRENTGEMMA_2B,
        MOONSHOT_V1_16B_A3B,
        ARCTIC_480B,
        SURVEY_DEMO,
    ]
}

ASSIGNED: List[str] = [
    "granite-34b",
    "seamless-m4t-medium",
    "gemma3-1b",
    "granite-8b",
    "falcon-mamba-7b",
    "phi-3-vision-4.2b",
    "qwen3-moe-30b-a3b",
    "recurrentgemma-2b",
    "moonshot-v1-16b-a3b",
    "arctic-480b",
]


def get_config(name: str) -> ArchConfig:
    try:
        return ARCHITECTURES[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCHITECTURES)}"
        ) from None


def get_shape(name: str) -> ShapeSpec:
    try:
        return INPUT_SHAPES[name]
    except KeyError:
        raise KeyError(
            f"unknown shape {name!r}; available: {sorted(INPUT_SHAPES)}"
        ) from None


def get_reduced(name: str, **over) -> ArchConfig:
    return reduced(get_config(name), **over)
