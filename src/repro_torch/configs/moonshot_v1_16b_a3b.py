"""moonshot-v1-16b-a3b — Moonshot Moonlight-16B-A3B. [hf:moonshotai/Moonlight-16B-A3B]

DeepSeek-V3-style MoE decoder: 48 layers, 64 routed experts top-6 plus 2
always-on shared experts, per-expert SwiGLU hidden 1408, MHA 16 heads
(kv=16) head_dim=128, vocab 163840.

Simplification noted in DESIGN.md: Moonlight's first dense layer is modeled
as MoE like the rest (uniform scan stack); its MLA attention is modeled as
standard MHA per the assignment table (16H kv=16).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
    mlp_gated=True,
    norm="rmsnorm",
    pattern=("attn",),
    ffn_kind="moe",
    n_experts=64,
    experts_top_k=6,
    n_shared_experts=2,
    long_context="sw_variant",
    source="hf:moonshotai/Moonlight-16B-A3B",
)
