"""phi-3-vision-4.2b — Microsoft Phi-3-vision-128k. [hf:microsoft/Phi-3-vision-128k-instruct]

VLM: phi3-mini dense decoder backbone (32L, d=3072, MHA 32 heads, SwiGLU
d_ff=8192, vocab 32064 padded to 32128) consuming CLIP-ViT patch embeddings.

The vision tower (CLIP ViT-L/14 + HD transform + projector) is the allowed
STUB: ``input_specs`` supplies precomputed, projected patch embeddings of
shape (batch, patches, d_model) which the model interleaves ahead of the text
tokens.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    mlp_gated=True,
    norm="rmsnorm",
    pattern=("attn",),
    ffn_kind="dense",
    frontend="vision",
    frontend_tokens=576,
    long_context="sw_variant",
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)
