"""falcon-mamba-7b — TII Falcon-Mamba 7B. [arXiv:2410.05355]

Pure Mamba-1 SSM stack: 64 attention-free blocks, d_model=4096, expand=2
(d_inner=8192), ssm_state=16, conv width 4, RMSNorm, vocab 65024. Each block
is mixer-only (Mamba-1 has no separate FFN half).

Decode is O(1)-state recurrent -> long_500k is native.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=65024,
    norm="rmsnorm",
    pattern=("mamba",),
    ffn_kind="none",
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    long_context="native",
    source="arXiv:2410.05355 (Falcon Mamba)",
)
