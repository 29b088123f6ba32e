"""Transformer architecture configs for the on-device model runtime.

The reference never executes a model (every forward pass is an HTTPS call,
src/utils.py:70); the model families it *calls* are Gemma-2 and Llama-3
(configs/appendix/{gemma,llama}/...).  These presets describe the same
families for local execution on the GPU (PyTorch port), plus tiny variants
for tests.  A copy of ``consensus_tpu/models/config.py``: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "tiny"
    vocab_size: int = 512
    d_model: int = 64
    n_layers: int = 2
    n_heads: int = 4
    n_kv_heads: int = 2
    head_dim: int = 16
    ffn_hidden: int = 128
    # "geglu" (Gemma: gelu-tanh gated) or "swiglu" (Llama: silu gated)
    activation: str = "geglu"
    rope_theta: float = 10_000.0
    # Llama-3.1 "llama3" rope scaling as (factor, low_freq_factor,
    # high_freq_factor, original_max_position_embeddings); None disables.
    rope_scaling: Optional[Tuple[float, float, float, int]] = None
    rms_eps: float = 1e-6
    # Gemma-2 style logit softcaps; None disables.
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    # Sliding-window size for local-attention layers; None = all global.
    sliding_window: Optional[int] = None
    # Pattern of local(=True)/global(=False) attention per layer, tiled.
    # Gemma-2 alternates local/global; Llama is all-global.
    local_layer_pattern: Tuple[bool, ...] = (False,)
    # Query scale: 1/sqrt(query_pre_attn_scalar). Gemma-2 uses d_model/n_heads
    # (2b/9b: 256), Llama uses head_dim.
    query_pre_attn_scalar: Optional[int] = None
    # Gemma multiplies token embeddings by sqrt(d_model).
    scale_embeddings: bool = True
    # Tie LM head to the embedding matrix (Gemma yes, Llama-3-8B no).
    tie_lm_head: bool = True
    # Gemma-2 adds post-attention/post-ffw RMSNorms; Llama has only pre-norms.
    use_post_norms: bool = True
    # RMSNorm scale convention: "gemma" computes x * (1 + w), "llama" x * w.
    rmsnorm_style: str = "gemma"
    # Use the hand-written flash-attention kernel on the no-cache (teacher-forced
    # scoring) path instead of materializing (B, H, S, S) logits.
    use_flash_attention: bool = False
    # Use the fused decode-attention kernel in the session step's
    # trunk-tail path (ops/decode_attention.py) instead of the einsum pair.
    use_decode_attention: bool = False

    @property
    def q_scale(self) -> float:
        scalar = self.query_pre_attn_scalar or self.head_dim
        return scalar ** -0.5

    def layer_is_local(self, layer: int) -> bool:
        return self.local_layer_pattern[layer % len(self.local_layer_pattern)]


def _gemma2(name: str, **kw) -> ModelConfig:
    base = dict(
        activation="geglu",
        rope_theta=10_000.0,
        attn_softcap=50.0,
        final_softcap=30.0,
        sliding_window=4096,
        local_layer_pattern=(True, False),  # even layers local, odd global
        scale_embeddings=True,
        tie_lm_head=True,
        use_post_norms=True,
        rmsnorm_style="gemma",
    )
    base.update(kw)
    return ModelConfig(name=name, **base)


def _llama3(name: str, **kw) -> ModelConfig:
    base = dict(
        activation="swiglu",
        rope_theta=500_000.0,
        attn_softcap=None,
        final_softcap=None,
        sliding_window=None,
        local_layer_pattern=(False,),
        scale_embeddings=False,
        tie_lm_head=False,
        use_post_norms=False,
        rmsnorm_style="llama",
        rms_eps=1e-5,
    )
    base.update(kw)
    return ModelConfig(name=name, **base)


MODEL_CONFIGS = {
    # Gemma-2 2.6B (google/gemma-2-2b): 26 layers, d=2304, 8 q / 4 kv heads,
    # head_dim 256, ffn 9216, vocab 256128.
    "gemma2-2b": _gemma2(
        "gemma2-2b",
        vocab_size=256_128,
        d_model=2304,
        n_layers=26,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        ffn_hidden=9216,
        query_pre_attn_scalar=256,
    ),
    # Gemma-2 9B (google/gemma-2-9b-it) — the reference's AAMAS generation
    # model (configs/appendix/gemma/*): 42 layers, d=3584, 16 q / 8 kv heads.
    "gemma2-9b": _gemma2(
        "gemma2-9b",
        vocab_size=256_128,
        d_model=3584,
        n_layers=42,
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,
        ffn_hidden=14336,
        query_pre_attn_scalar=224,
    ),
    # Llama-3.1 8B (meta-llama/Meta-Llama-3.1-8B-Instruct-Turbo in the
    # reference's main-body configs): 32 layers, d=4096, 32 q / 8 kv heads,
    # "llama3" rope scaling (HF config.json rope_scaling; certified against
    # transformers in tests/test_hf_numerics.py).
    "llama3-8b": _llama3(
        "llama3-8b",
        vocab_size=128_256,
        d_model=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        ffn_hidden=14336,
        rope_scaling=(8.0, 1.0, 4.0, 8192),
    ),
    # Tiny variants for tests / CPU smoke runs.
    "tiny-gemma2": _gemma2(
        "tiny-gemma2",
        vocab_size=512,
        d_model=64,
        n_layers=4,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        ffn_hidden=128,
        sliding_window=16,
        query_pre_attn_scalar=16,
    ),
    "tiny-llama3": _llama3(
        "tiny-llama3",
        vocab_size=512,
        d_model=64,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        ffn_hidden=128,
    ),
}


def get_model_config(name: str, **overrides) -> ModelConfig:
    """Look up a preset by name, optionally overriding fields."""
    if name not in MODEL_CONFIGS:
        raise ValueError(f"Unknown model config: {name!r}. Known: {sorted(MODEL_CONFIGS)}")
    config = MODEL_CONFIGS[name]
    if overrides:
        config = dataclasses.replace(config, **overrides)
    return config
