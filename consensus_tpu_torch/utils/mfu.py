"""Model-FLOPs-utilization accounting (PyTorch port of
``consensus_tpu/utils/mfu.py``), against the H100's peak.

Accounting convention: useful FLOPs = ``2 * params * useful_token``, where
useful tokens are generated + scored tokens actually consumed by a caller;
bucket padding, KV and weight memory traffic and host time all show up as
LOST utilization, which is the point of the number.  The embedding matrix
counts once (it is a gather on the way in and the head matmul on the way
out).
"""

from __future__ import annotations

#: NVIDIA H100 SXM dense bf16 tensor-core peak, TFLOP/s (NVIDIA's H100
#: datasheet; 1978.9 with sparsity).  The card ``chip_smoke.py`` runs on.
H100_SXM_BF16_PEAK_TFLOPS = 989.4


def param_count(config) -> int:
    """Logical parameter count from a ModelConfig (quantization-agnostic)."""
    c = config
    attn = c.d_model * (c.n_heads * c.head_dim) * 2  # wq + wo
    attn += c.d_model * (c.n_kv_heads * c.head_dim) * 2  # wk + wv
    ffn = 3 * c.d_model * c.ffn_hidden  # gate, up, down
    norms = (4 if c.use_post_norms else 2) * c.d_model
    per_layer = attn + ffn + norms
    total = c.n_layers * per_layer + c.vocab_size * c.d_model + c.d_model
    if not c.tie_lm_head:
        total += c.vocab_size * c.d_model
    return int(total)


def useful_tflops_per_sec(n_params: int, tokens: int, wall_s: float) -> float:
    if wall_s <= 0:
        return 0.0
    return 2.0 * n_params * tokens / wall_s / 1e12


def pct_of_peak(
    tflops: float, peak: float = H100_SXM_BF16_PEAK_TFLOPS, n_devices: int = 1
) -> float:
    """Percent of aggregate peak.  ``n_devices`` scales the denominator to
    the number of cards: quoting a multi-card run against one card's peak
    would flatter the number by that factor.  Single-card callers (the
    default) are unchanged."""
    return 100.0 * tflops / (peak * max(1, int(n_devices)))
