"""gemma3-1b — Google Gemma 3 1B pretrained. [hf:google/gemma-3-1b-pt]

Dense decoder, 5:1 local:global attention pattern (5 sliding-window layers per
1 full-attention layer), MQA (kv=1), head_dim=256 (explicit: 4 heads x 256 =
1024 != d_model), 262144-token SentencePiece vocab, SwiGLU.

sliding_window=512 per the HF config (4x128 — MXU-tile aligned). Because only
1 layer in 6 keeps a full cache, long_500k decode is natively sub-quadratic in
aggregate cache memory: 26 layers -> 5 global x 512k + 21 local x 512.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    mlp_gated=True,
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    pattern=("local", "local", "local", "local", "local", "attn"),
    sliding_window=512,
    ffn_kind="dense",
    long_context="native",
    source="hf:google/gemma-3-1b-pt",
)
