"""recurrentgemma-2b — Google RecurrentGemma 2B (Griffin). [arXiv:2402.19427]

Hybrid: repeating unit of (RG-LRU, RG-LRU, local-attention) — 1 attention per
2 recurrent blocks. 26 layers, d_model=2560, 10 heads MQA head_dim=256,
gated-GeLU d_ff=7680 (geglu treated as gated MLP), rglru width 2560, local
window 2048, vocab 256000.

RG-LRU state is O(width) and local attention is windowed -> long_500k native.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    mlp_gated=True,
    norm="rmsnorm",
    pattern=("rglru", "rglru", "local"),
    sliding_window=2048,
    ffn_kind="dense",
    rglru_width=2560,
    ssm_conv=4,
    long_context="native",
    source="arXiv:2402.19427 (Griffin / RecurrentGemma)",
)
