"""qwen3-moe-30b-a3b — Qwen3-30B-A3B. [hf:Qwen/Qwen3-30B-A3B]

MoE decoder: 48 layers, every FFN is a 128-expert top-8 router with per-expert
SwiGLU hidden 768. GQA 32q/4kv with explicit head_dim=128 (q width 4096 !=
d_model=2048 — matches the HF config). Vocab 151936.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    mlp_gated=True,
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    pattern=("attn",),
    ffn_kind="moe",
    n_experts=128,
    experts_top_k=8,
    long_context="sw_variant",
    source="hf:Qwen/Qwen3-30B-A3B",
)
