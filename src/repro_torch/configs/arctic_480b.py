"""arctic-480b — Snowflake Arctic base. [hf:Snowflake/snowflake-arctic-base]

Dense-MoE hybrid: 35 layers, 128-expert top-2 router (per-expert SwiGLU hidden
4864) in PARALLEL with a dense residual SwiGLU MLP on every layer (Arctic's
"dense + MoE hybrid" design). GQA 56q/8kv head_dim=128, d_model=7168,
vocab 32000.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    mlp_gated=True,
    norm="rmsnorm",
    pattern=("attn",),
    ffn_kind="moe",
    n_experts=128,
    experts_top_k=2,
    dense_residual=True,
    residual_d_ff=4864,
    long_context="sw_variant",
    source="hf:Snowflake/snowflake-arctic-base",
)
