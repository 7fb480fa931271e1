"""granite-8b — IBM Granite 8B Code. [arXiv:2405.04324]

Llama-arch dense decoder with GQA (32 q heads / 8 kv heads), SwiGLU MLP.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    mlp_gated=True,
    norm="rmsnorm",
    pattern=("attn",),
    ffn_kind="dense",
    long_context="sw_variant",
    source="arXiv:2405.04324 (Granite Code Models)",
)
