"""seamless-m4t-medium — Meta SeamlessM4T medium text backbone. [arXiv:2308.11596]

Encoder-decoder transformer (12 enc + 12 dec layers per the M4T-medium text
enc/dec depth; the assignment's "12L" is read as the per-stack depth — noted
in DESIGN.md). MHA (kv=16 == heads), plain MLP with d_ff=4096, LayerNorm,
256206-entry NLLB vocab (padded to 256256 for mesh divisibility).

The audio frontend (mel filterbank + conformer feature extractor) is the
allowed STUB: ``input_specs`` supplies precomputed frame embeddings of shape
(batch, frames, d_model) consumed directly by the encoder.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    mlp_gated=False,
    norm="layernorm",
    pattern=("attn",),
    ffn_kind="dense",
    frontend="audio",
    frontend_tokens=1024,
    long_context="sw_variant",
    source="arXiv:2308.11596 (SeamlessM4T)",
)
