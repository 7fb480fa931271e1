"""Architecture and input-shape configuration.

Every assigned architecture is expressed as an :class:`ArchConfig`. The model
builder (``repro.models``) consumes only this dataclass, so new architectures
are pure config additions.

Block model
-----------
A network is a stack of ``n_layers`` blocks. Each block has a *mixer* (the
sequence-mixing half) and an *ffn* (the channel-mixing half):

  mixer ∈ {"attn" (full causal), "local" (sliding-window attn),
           "rglru" (RG-LRU linear recurrence), "mamba" (Mamba-1 SSM)}
  ffn   ∈ {"dense", "moe", "none"}

``pattern`` gives the repeating unit of mixer kinds (e.g. gemma3's
``("local",)*5 + ("attn",)``); homogeneous stacks use a length-1 pattern.
Encoder-decoder models additionally set ``enc_layers > 0`` (the encoder is a
non-causal homogeneous attention stack; decoder blocks gain cross-attention).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

MIXER_KINDS = ("attn", "local", "rglru", "mamba")
FFN_KINDS = ("dense", "moe", "none")

# Pad vocab so it is MXU-tile aligned and divisible by the model mesh axis.
VOCAB_PAD_MULTIPLE = 128


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Static architecture description (full-size, dry-run only)."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                     # query heads (0 for attention-free)
    n_kv_heads: int                  # GQA kv heads (0 for attention-free)
    d_ff: int                        # dense FFN hidden (per-expert hidden for MoE)
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    mlp_gated: bool = True           # SwiGLU-style gated MLP vs plain 2-matrix MLP
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False

    # --- layer pattern -----------------------------------------------------
    pattern: Tuple[str, ...] = ("attn",)
    ffn_kind: str = "dense"
    sliding_window: int = 0          # window for "local" mixers

    # --- encoder-decoder ---------------------------------------------------
    enc_layers: int = 0              # >0 => enc-dec; n_layers is decoder depth

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    experts_top_k: int = 0
    n_shared_experts: int = 0        # always-on shared experts (Moonlight)
    dense_residual: bool = False     # parallel dense FFN next to routed (Arctic)
    residual_d_ff: int = 0           # hidden of the dense-residual FFN
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- SSM / RG-LRU ------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    rglru_width: int = 0             # 0 -> d_model

    # --- modality frontend (stub: precomputed embeddings) -------------------
    frontend: Optional[str] = None   # None | "audio" | "vision"
    frontend_tokens: int = 0         # patches / frames consumed per example

    # --- long-context (long_500k) handling ----------------------------------
    # "native"      : the base pattern is already sub-quadratic (ssm / hybrid /
    #                 local:global) — run long_500k as-is.
    # "sw_variant"  : base arch is pure full attention; long_500k runs a
    #                 sliding-window variant (window=lc_window, global layer
    #                 every lc_global_every) — flagged in EXPERIMENTS.md.
    long_context: str = "sw_variant"
    lc_window: int = 4096
    lc_global_every: int = 8

    # --- provenance ---------------------------------------------------------
    source: str = ""

    # ------------------------------------------------------------------ utils
    def __post_init__(self):
        if self.n_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.pattern:
            for m in self.pattern:
                assert m in MIXER_KINDS, m
        assert self.ffn_kind in FFN_KINDS, self.ffn_kind
        if self.n_experts:
            assert self.experts_top_k > 0

    @property
    def vocab_padded(self) -> int:
        return pad_to(self.vocab_size, VOCAB_PAD_MULTIPLE)

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def attention_free(self) -> bool:
        return all(m in ("rglru", "mamba") for m in self.pattern)

    @property
    def d_inner(self) -> int:
        """Mamba inner width."""
        return self.ssm_expand * self.d_model

    def mixer_kinds(self, n_layers: Optional[int] = None) -> Tuple[str, ...]:
        """Per-layer mixer kinds for a stack of ``n_layers`` (default full)."""
        n = self.n_layers if n_layers is None else n_layers
        reps = math.ceil(n / len(self.pattern))
        return (self.pattern * reps)[:n]

    # --------------------------------------------------------------- counting
    def param_count(self) -> Dict[str, int]:
        """Analytic parameter counts (used for MODEL_FLOPS and memory maths)."""
        d, dff, hd = self.d_model, self.d_ff, self.head_dim
        counts: Dict[str, int] = {}
        counts["embed"] = self.vocab_padded * d
        counts["head"] = 0 if self.tie_embeddings else self.vocab_padded * d

        def attn_params() -> int:
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            return q + kv + o

        def dense_ffn(hidden: int) -> int:
            return (3 if self.mlp_gated else 2) * d * hidden

        def mixer_params(kind: str) -> int:
            if kind in ("attn", "local"):
                return attn_params()
            if kind == "mamba":
                di, s = self.d_inner, self.ssm_state
                in_proj = d * 2 * di
                conv = di * self.ssm_conv
                xbcdt = di * (2 * s + (di // 16)) + (di // 16) * di
                out = di * d
                return in_proj + conv + xbcdt + out + 2 * di
            if kind == "rglru":
                w = self.rglru_width or d
                conv = w * self.ssm_conv
                return 2 * d * w + w * d + conv + 3 * w + 2 * (w // 8) * w
            raise ValueError(kind)

        def ffn_params() -> int:
            if self.ffn_kind == "none":
                return 0
            if self.ffn_kind == "dense":
                return dense_ffn(dff)
            routed = self.n_experts * (3 if self.mlp_gated else 2) * d * dff
            router = d * self.n_experts
            shared = self.n_shared_experts * dense_ffn(dff)
            resid = dense_ffn(self.residual_d_ff) if self.dense_residual else 0
            return routed + router + shared + resid

        layers = 0
        for kind in self.mixer_kinds():
            layers += mixer_params(kind) + ffn_params() + 2 * d  # two norms
        if self.is_encdec:
            enc = self.enc_layers * (attn_params() + dense_ffn(dff) + 2 * d)
            cross = self.n_layers * (attn_params() + d)          # cross-attn+norm
            layers += enc + cross
        counts["layers"] = layers
        counts["final_norm"] = d
        counts["total"] = sum(counts.values())
        return counts

    def active_param_count(self) -> int:
        """Active params per token (= total for dense; router top-k for MoE)."""
        if not self.n_experts:
            return self.param_count()["total"]
        full = self.param_count()["total"]
        d, dff = self.d_model, self.d_ff
        per_expert = (3 if self.mlp_gated else 2) * d * dff
        inactive = (self.n_experts - self.experts_top_k) * per_expert
        return full - self.n_layers * inactive


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def reduced(cfg: ArchConfig, **over: Any) -> ArchConfig:
    """A smoke-test-sized variant of the same family (2 layers, d<=512, <=4 experts).

    Keeps the mixer pattern (truncated), GQA ratio, gating, MoE/SSM structure.
    """
    d = min(cfg.d_model, 256)
    n_heads = max(1, min(cfg.n_heads, 4))
    ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1)) if cfg.n_heads else 1
    n_kv = max(1, n_heads // ratio) if cfg.n_heads else 0
    upd: Dict[str, Any] = dict(
        name=cfg.name + "-reduced",
        n_layers=max(2, len(cfg.pattern)) if len(cfg.pattern) > 1 else 2,
        d_model=d,
        n_heads=n_heads if cfg.n_heads else 0,
        n_kv_heads=n_kv,
        head_dim=(d // n_heads) if cfg.n_heads else 0,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 1024),
        enc_layers=2 if cfg.is_encdec else 0,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        experts_top_k=min(cfg.experts_top_k, 2) if cfg.n_experts else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        residual_d_ff=min(cfg.residual_d_ff, 256) if cfg.dense_residual else 0,
        rglru_width=min(cfg.rglru_width, 256) if cfg.rglru_width else 0,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        lc_window=256,
        frontend_tokens=min(cfg.frontend_tokens, 16),
    )
    upd.update(over)
    return dataclasses.replace(cfg, **upd)
