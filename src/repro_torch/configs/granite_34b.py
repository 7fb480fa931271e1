"""granite-34b — IBM Granite 34B Code. [arXiv:2405.04324]

GPT-BigCode-style dense decoder: MQA (kv=1), plain (non-gated) MLP — the
non-gated MLP is what makes 88 x (attn + 2*d*d_ff) + embeddings land at ~34B
with d_ff = 4*d_model.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    mlp_gated=False,
    norm="layernorm",
    pattern=("attn",),
    ffn_kind="dense",
    long_context="sw_variant",
    source="arXiv:2405.04324 (Granite Code Models)",
)
